"""Typed application configuration of the port.

The ``compression``, ``logging`` and ``output`` sections, the sources and the
``DATACOMP_<SECTION>_<KEY>`` variables are those of ``datacomp_tpu/config.py``,
so one setting gives both packages the same ``.dcz`` bytes.  Each section
keeps only the fields the port reads: the TPU knobs (histogram backend,
fallback), the fields only the JAX package's UI and benchmark read,
and the ``benchmark`` section have no user here yet.  Unknown keys in a file
or the environment are ignored.

Config sources, in override order (lowest → highest):
1. built-in defaults below,
2. a TOML file (``datacomp.toml`` in CWD, or ``DATACOMP_CONFIG`` env var),
3. ``DATACOMP_<SECTION>_<KEY>`` environment variables,
4. explicit keyword overrides passed to :func:`load_config`.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field, fields, replace
from typing import Any, Optional


@dataclass(frozen=True)
class CompressionConfig:
    chunk_size_mb: int = 16
    cpu_threads: int = 0  # 0 = auto (clamp(cores, 2, 8), reference parity)
    use_memory_mapped_io: bool = True
    # v2 gap-array granularity (symbols per sub-block).  4032 = 2^6*3^2*7:
    # divisible by 32 (device-encode group size) and by 2/3/4 so the device
    # decoder can pick any symbols-per-refill rate the codebook depth allows.
    subblock_symbols: int = 4032
    format_version: int = 1  # 1 = reference-bit-compatible, 2 = +gap arrays
    codebook_mode: str = "java"  # "java" = bit-exact reference tie-breaks, "fast"
    # Cap on per-symbol code length (0 = unlimited, reference parity;
    # -1/"auto" = shallowest cap costing < 0.5% extra bits).  When a chunk's
    # optimal code is deeper, the optimal length-limited code is built
    # instead (package-merge).  Codes ≤ 16 keep v2 decode on-device; ≤ 10/8
    # raise the device decoder's symbols-per-refill rate to 3/4.
    max_code_len: int = 0

    def effective_max_code_len(self) -> int:
        """v2 containers default to the auto cap (the format exists for
        device decode, whose speed scales with 32/max_len); v1 keeps exact
        reference parity.  Explicit values — including 32 as an effective
        opt-out — pass through."""
        if self.max_code_len == 0 and self.format_version >= 2:
            return -1
        return self.max_code_len


@dataclass(frozen=True)
class DeviceConfig:
    force_cpu: bool = False  # the host codec instead of the GPU service
    platform: str = "any"  # "cpu" = the kernels' plain versions; else CUDA
    device_index: int = -1  # -1 = auto
    # chunks in flight at once (pipeline workers: host prepass overlaps device)
    parallel_chunks: int = 3
    # chunks a device call takes, on both directions (one launch of each
    # kernel a group): 0 = auto (4 on a CUDA device, 1 on the CPU), else 1..16
    batch_chunks: int = 0


@dataclass(frozen=True)
class LoggingConfig:
    level: str = "INFO"
    metrics_enabled: bool = True
    file_path: str = ""


@dataclass(frozen=True)
class OutputConfig:
    verify_after_compress: bool = True


@dataclass(frozen=True)
class AppConfig:
    compression: CompressionConfig = field(default_factory=CompressionConfig)
    device: DeviceConfig = field(default_factory=DeviceConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    output: OutputConfig = field(default_factory=OutputConfig)

    @property
    def chunk_size_bytes(self) -> int:
        return self.compression.chunk_size_mb * 1024 * 1024

    def effective_cpu_threads(self) -> int:
        n = self.compression.cpu_threads
        if n > 0:
            return n
        cores = os.cpu_count() or 2
        return max(2, min(cores, 8))  # reference parity: CpuCompressionService.java:42-44


_SECTION_TYPES = {
    "compression": CompressionConfig,
    "device": DeviceConfig,
    "logging": LoggingConfig,
    "output": OutputConfig,
}


def _coerce(value: str, target_type: type) -> Any:
    if target_type is bool:
        return value.strip().lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    return value


def _apply_section(section_obj, overrides: dict):
    valid = {f.name: f.type for f in fields(section_obj)}
    clean = {}
    for k, v in overrides.items():
        key = k.replace("-", "_")
        if key == "max_code_len" and v == "auto":
            v = -1
        if key in valid:
            clean[key] = v
    return replace(section_obj, **clean)


def load_config(path: Optional[str] = None, **overrides) -> AppConfig:
    """Load configuration from defaults + TOML file + env + overrides.

    ``overrides`` are flat dotted keys, e.g.
    ``load_config(compression={"chunk_size_mb": 32})``.
    """
    cfg = AppConfig()

    file_path = path or os.environ.get("DATACOMP_CONFIG")
    if file_path is None and os.path.exists("datacomp.toml"):
        file_path = "datacomp.toml"
    file_data: dict = {}
    if file_path and os.path.exists(file_path):
        with open(file_path, "rb") as f:
            file_data = tomllib.load(f)
        # allow a top-level [datacomp] table like the reference's `datacomp {}`
        file_data = file_data.get("datacomp", file_data)

    sections = {}
    for name, _ in _SECTION_TYPES.items():
        section = getattr(cfg, name)
        if name in file_data and isinstance(file_data[name], dict):
            section = _apply_section(section, file_data[name])
        # env vars: DATACOMP_COMPRESSION_CHUNK_SIZE_MB=32
        env_over = {}
        prefix = f"DATACOMP_{name.upper()}_"
        for ek, ev in os.environ.items():
            if ek.startswith(prefix):
                key = ek[len(prefix) :].lower()
                for f in fields(section):
                    if f.name == key:
                        if key == "max_code_len" and ev.strip().lower() == "auto":
                            env_over[key] = -1
                            continue
                        try:
                            env_over[key] = _coerce(ev, type(getattr(section, key)))
                        except ValueError:
                            pass
        if env_over:
            section = _apply_section(section, env_over)
        if name in overrides and isinstance(overrides[name], dict):
            section = _apply_section(section, overrides[name])
        sections[name] = section

    cfg = AppConfig(**sections)
    _validate(cfg)
    return cfg


def _validate(cfg: AppConfig) -> None:
    """Config diagnostics shared by every entry point, flagged once at load
    time (the JAX package's checks of the sections kept here)."""
    import logging

    comp = cfg.compression
    if comp.codebook_mode not in ("java", "fast", "device"):
        raise ValueError(
            f"codebook-mode must be java|fast|device, got {comp.codebook_mode!r}"
        )
    if comp.max_code_len not in (-1, 0) and not 1 <= comp.max_code_len <= 32:
        raise ValueError(
            f"max-code-len must be -1/'auto', 0 (unlimited) or 1..32, got {comp.max_code_len}"
        )
    if comp.max_code_len and comp.codebook_mode == "device":
        logging.getLogger(__name__).warning(
            "max_code_len=%d is ignored in codebook_mode='device' (the "
            "on-device builder emits unconstrained optimal codes); use "
            "codebook_mode='fast' for length-limited codebooks",
            comp.max_code_len,
        )
    if comp.format_version >= 2 and comp.subblock_symbols % 32:
        raise ValueError(
            f"subblock-symbols must be a multiple of 32, got {comp.subblock_symbols}"
        )
    if not 0 <= cfg.device.batch_chunks <= 16:
        raise ValueError(
            f"batch-chunks must be 0 (auto) or 1..16, got {cfg.device.batch_chunks}"
        )
