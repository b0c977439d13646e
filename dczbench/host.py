"""The host a run stands on: the card's NUMA-local cores, and the facts a run
prints so that a spread between runs can be laid beside them.

Nothing here imports torch: :func:`bind_to_card` runs before it, so that
every thread the program starts inherits the binding.
"""

from __future__ import annotations

import glob
import os
import resource
import shutil
import subprocess
import time

_PCI = "/sys/bus/pci/devices"
_NVIDIA = "0x10de"


def _read(path: str, default: str = "") -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return default


def parse_cpulist(text: str) -> set:
    """``"0-3,8,10-11"`` -> {0, 1, 2, 3, 8, 10, 11}."""
    cpus = set()
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        lo, _, hi = part.partition("-")
        cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def card_pci_address() -> str | None:
    """The PCI address of the card the run uses: the NVIDIA display or 3D
    controllers in address order, the first one ``CUDA_VISIBLE_DEVICES``
    names when it names one by index."""
    cards = sorted(
        os.path.basename(d) for d in glob.glob(os.path.join(_PCI, "*"))
        if _read(os.path.join(d, "vendor")) == _NVIDIA
        and _read(os.path.join(d, "class")).startswith(("0x0300", "0x0302"))
    )
    if not cards:
        return None
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    index = int(first) if first.isdigit() else 0
    return cards[index] if index < len(cards) else cards[0]


def bind_to_card() -> dict:
    """Bind this process to the card's NUMA-local cores, read from sysfs
    (``local_cpulist``), where that list meets the cores the process was
    given; else keep the affinity it has.  Returns what was done."""
    given = sorted(os.sched_getaffinity(0))
    card = card_pci_address()
    local = parse_cpulist(_read(os.path.join(_PCI, card, "local_cpulist"))) if card else set()
    chosen = sorted(local.intersection(given))
    if chosen:
        os.sched_setaffinity(0, chosen)
        how = "bound to the card's NUMA-local cores"
    else:
        chosen = given
        how = ("kept the given affinity: "
               + ("no card in sysfs" if card is None else "sysfs gives no local core of those given"))
    return {"card": card, "numa_node": _read(os.path.join(_PCI, card, "numa_node"), "?")
            if card else "?", "cores": _compact(chosen), "given": _compact(given), "how": how}


def _compact(cpus) -> str:
    """[0, 1, 2, 5] -> "0-2,5"."""
    out, run = [], []
    for c in sorted(cpus):
        if run and c == run[-1] + 1:
            run.append(c)
            continue
        if run:
            out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
        run = [c]
    if run:
        out.append(f"{run[0]}-{run[-1]}" if len(run) > 1 else str(run[0]))
    return ",".join(out)


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat`` against
    ``/proc/uptime``, to the kernel's tick)."""
    fields = _read("/proc/self/stat").rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return float(_read("/proc/uptime").split()[0]) - started


def cpu_model() -> str:
    for line in _read("/proc/cpuinfo").splitlines():
        if line.startswith("model name"):
            return line.split(":", 1)[1].strip()
    return "?"


def cpu_mhz() -> float | None:
    """Mean ``cpu MHz`` of the cores this process may run on."""
    mine = os.sched_getaffinity(0)
    mhz, proc = [], None
    for line in _read("/proc/cpuinfo").splitlines():
        if line.startswith("processor"):
            proc = int(line.split(":")[1])
        elif line.startswith("cpu MHz") and proc in mine:
            mhz.append(float(line.split(":")[1]))
    return round(sum(mhz) / len(mhz), 1) if mhz else None


def _cpu_ticks() -> dict:
    """iowait and steal ticks of all cores (``/proc/stat``)."""
    f = _read("/proc/stat").splitlines()[0].split()
    return {"iowait": int(f[5]), "steal": int(f[8]) if len(f) > 8 else 0}


def _meminfo() -> dict:
    out = {}
    for line in _read("/proc/meminfo").splitlines():
        key, _, rest = line.partition(":")
        if key in ("MemAvailable", "Dirty"):
            out[key + "_MB"] = round(int(rest.split()[0]) / 1024, 1)
    return out


def io_bytes() -> dict:
    """``/proc/self/io``: bytes this process sent to storage, and those of
    pages it dirtied and then deleted before they were written."""
    out = {}
    for line in _read("/proc/self/io").splitlines():
        key, _, val = line.partition(":")
        if key in ("write_bytes", "cancelled_write_bytes", "wchar"):
            out[key] = int(val)
    return out


def fs_of(path: str) -> str:
    """The file system type under ``path`` (``/proc/mounts``)."""
    best, kind = "", "?"
    path = os.path.realpath(path)
    for line in _read("/proc/mounts").splitlines():
        parts = line.split()
        if len(parts) > 2 and path.startswith(parts[1]) and len(parts[1]) > len(best):
            best, kind = parts[1], parts[2]
    return kind


def card_readings(index: int = 0) -> dict:
    """The card's SM clock, power draw and power limit (``nvidia-smi``)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return {"nvidia_smi": "absent"}
    try:
        out = subprocess.run(
            [smi, "-i", str(index), "--query-gpu=clocks.sm,power.draw,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"nvidia_smi": f"failed: {e}"}
    parts = [p.strip() for p in out.strip().split(",")]
    return dict(zip(("sm_clock", "power_draw", "power_limit"), parts)) if len(parts) == 3 \
        else {"nvidia_smi": out.strip()[:120]}


def cpu_probe() -> dict:
    """The host's memory copy rate (128 MiB, best of 3) and SHA-256 rate
    (32 MiB), the two kinds of host work the program does most."""
    import hashlib

    import numpy as np

    src = np.ones(128 << 20, np.uint8)
    dst = np.empty_like(src)
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t)
    t = time.perf_counter()
    hashlib.sha256(memoryview(src)[: 32 << 20]).digest()
    sha = time.perf_counter() - t
    return {"copy_GBps": round(src.nbytes / best / 1e9, 2),
            "sha256_MBps": round((32 << 20) / sha / 1e6, 1)}


class Facts:
    """Host facts at the window's start, and what changed by its end."""

    def __init__(self, device_index=None):
        self.device_index = device_index
        self.start = self._snap()

    def _snap(self) -> dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        snap = {"t": time.perf_counter(), "cpu_MHz": cpu_mhz(), "ticks": _cpu_ticks(),
                "probe": cpu_probe(),
                "minflt": ru.ru_minflt, "majflt": ru.ru_majflt,
                "loadavg": _read("/proc/loadavg").split()[:3], **_meminfo()}
        if self.device_index is not None:
            snap["card"] = card_readings(self.device_index)
        return snap

    def finish(self) -> dict:
        end = self._snap()
        s = self.start
        return {
            "cpu_MHz": [s["cpu_MHz"], end["cpu_MHz"]],
            "probe": [s["probe"], end["probe"]],
            "steal_ticks": end["ticks"]["steal"] - s["ticks"]["steal"],
            "iowait_ticks": end["ticks"]["iowait"] - s["ticks"]["iowait"],
            "minor_faults": end["minflt"] - s["minflt"],
            "major_faults": end["majflt"] - s["majflt"],
            "loadavg": [s["loadavg"], end["loadavg"]],
            "MemAvailable_MB": [s.get("MemAvailable_MB"), end.get("MemAvailable_MB")],
            "Dirty_MB": [s.get("Dirty_MB"), end.get("Dirty_MB")],
            "card": [s.get("card"), end.get("card")],
        }
