"""The port's CLI against the JAX package's, on the CPU: the same commands
write the same ``.dcz`` bytes, and the two ``build_parser()`` trees have the
same verbs, aliases, options, choices (``tpu`` read as ``gpu``) and
defaults.

``compress --sharded`` with no other flag writes format 2 with the device
codebook in both.  ``--max-code-len`` gives the JAX ``--backend cpu`` file
through the port's ``--backend cpu`` (the host codec) and ``--backend gpu``
(the GPU service, on the kernels' plain versions under
``DATACOMP_DEVICE_PLATFORM=cpu``).  ``--backend gpu`` and ``auto`` never
fall back to the host: without a CUDA device they exit non-zero and write
nothing.  The input is Zipf-distributed bytes made from a seed, two chunks
of 1 MiB whose optimal codes are 17 bits deep; everything compared is bytes
or integers, so every comparison is exact.
"""

import argparse
import os

import numpy as np
import pytest
import torch

import datacomp_tpu.cli as jcli
import datacomp_tpu.config as jconfig
from datacomp_tpu_torch import cli as pcli
from datacomp_tpu_torch import ops
from datacomp_tpu_torch.core import huffman, read_container
from datacomp_tpu_torch.services import gpu_service, pipeline

CHUNK = 1 << 20  # the commands' chunk size, "1" MB
SIZE = CHUNK + (200 << 10)  # two chunks, the second short
CAP = 12


def _zipf(seed: int, n: int, exponent: float = 2.0) -> np.ndarray:
    p = 1.0 / np.arange(1, 257) ** exponent
    return np.random.default_rng(seed).choice(256, size=n, p=p / p.sum()).astype(np.uint8)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "in.bin"
    path.write_bytes(_zipf(13, SIZE).tobytes())
    return str(path)


def _hists(path: str) -> list:
    data = np.fromfile(path, np.uint8)
    return [np.bincount(data[i : i + CHUNK], minlength=256) for i in range(0, data.size, CHUNK)]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _calls() -> dict:
    """(kernel launches, plain-version calls) of every op, and the host routes."""
    return {**{name: (k.value, r.value) for name, (k, r) in ops.COUNTERS.items()},
            "encode_routes": gpu_service.host_encode_routes.value,
            "decode_routes": gpu_service.host_decode_routes.value}


def _delta(before: dict) -> dict:
    now = _calls()
    return {name: (tuple(a - b for a, b in zip(v, before[name])) if isinstance(v, tuple)
                   else v - before[name]) for name, v in now.items()}


@pytest.fixture
def no_cuda(monkeypatch):
    """No CUDA device, and nothing in the environment that selects the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for key in ("DATACOMP_DEVICE_PLATFORM", "DATACOMP_DEVICE_FORCE_CPU",
                "DATACOMP_DEVICE_AUTO_DETECT"):
        monkeypatch.delenv(key, raising=False)


def test_input_is_deeper_than_the_cap(src):
    depths = [int(huffman.build_code_lengths(h, mode="fast").max()) for h in _hists(src)]
    assert len(depths) == 2 and min(depths) > CAP


def test_cli_sharded_defaults_write_the_jax_file(src, tmp_path, monkeypatch, capsys):
    """``compress IN OUT 1 --sharded`` alone: the JAX CLI (a mesh of its 8
    virtual CPU devices) and the port's (one rank on the plain versions)
    write the same v2 file with gap arrays; ``decompress --sharded`` through
    the port restores the input."""
    j, p, out = (str(tmp_path / f) for f in ("j.dcz", "p.dcz", "p.out"))
    assert jcli.main(["compress", src, j, "1", "--sharded"]) == 0
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    assert pcli.main(["compress", src, p, "1", "--sharded"]) == 0
    assert "Verify:     OK" in capsys.readouterr().out
    assert _read(p) == _read(j)
    header, _ = read_container(p)
    assert header.version == 2 and len(header.chunks) == 2
    assert all(c.gap_bits is not None and c.gap_bits.size for c in header.chunks)
    for c, h in zip(header.chunks, _hists(src)):  # the device codebook: uncapped, optimal
        assert c.code_lengths.max() > 16
        assert int(h @ c.code_lengths) == int(h @ huffman.build_code_lengths(h, mode="fast"))
    assert pcli.main(["decompress", p, out, "1", "--sharded"]) == 0
    assert _read(out) == _read(src)


@pytest.mark.parametrize("flags", [
    ["--format", "2", "--codebook-mode", "fast", "--max-code-len", str(CAP)],
    ["--format", "2", "--codebook-mode", "fast", "--max-code-len", "auto"],
    ["--format", "1", "--max-code-len", str(CAP)],
], ids=["fast-v2-12", "fast-v2-auto", "v1-12"])
def test_cli_max_code_len_matches_jax(src, tmp_path, monkeypatch, capsys, flags):
    """The same flags through the JAX CLI's ``--backend cpu``, the port's
    ``--backend cpu`` and its ``--backend gpu`` on the plain versions: one
    file, every chunk's codes no deeper than the cap (auto: the cap
    ``resolve_auto_cap`` picks), and the GPU service encoded every chunk
    on the plain K2."""
    j, pc, pg, out = (str(tmp_path / f) for f in ("j.dcz", "pc.dcz", "pg.dcz", "pg.out"))
    assert jcli.main(["compress", src, j, "1", *flags, "--backend", "cpu"]) == 0
    assert pcli.main(["compress", src, pc, "1", *flags, "--backend", "cpu"]) == 0
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    before = _calls()
    assert pcli.main(["compress", src, pg, "1", *flags, "--backend", "gpu"]) == 0
    delta = _delta(before)
    assert capsys.readouterr().out.count("Verify:     OK") == 3
    assert _read(pc) == _read(j) and _read(pg) == _read(j)
    assert delta["encode"] == (0, 2) and delta["encode_routes"] == 0
    header, _ = read_container(pg)
    assert header.version == int(flags[1])
    for c, h in zip(header.chunks, _hists(src)):
        uncapped = huffman.build_code_lengths(h, mode="fast")
        cap = CAP if flags[-1] != "auto" else huffman.resolve_auto_cap(h, uncapped)
        assert 0 < c.code_lengths.max() <= cap < uncapped.max()
    assert pcli.main(["decompress", pg, out, "1", "--backend", "cpu"]) == 0
    assert _read(out) == _read(src)


@pytest.mark.parametrize("sharded", [False, True], ids=["unsharded", "sharded"])
def test_cli_max_code_len_refused(src, tmp_path, monkeypatch, capsys, sharded):
    """``--max-code-len 40``: both CLIs exit 1 with the config's message and
    write nothing."""
    extra = ["--sharded"] if sharded else []
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    errs = []
    for main, name in ((jcli.main, "j.dcz"), (pcli.main, "p.dcz")):
        assert main(["compress", src, str(tmp_path / name), "1", "--max-code-len", "40",
                     *extra]) == 1
        errs.append(capsys.readouterr().err)
    assert errs[0] == errs[1]
    assert "max-code-len must be -1/'auto', 0 (unlimited) or 1..32, got 40" in errs[1]
    assert os.listdir(tmp_path) == []


@pytest.fixture(scope="module")
def capped(src, tmp_path_factory):
    """The port's fast v2 file at ``--max-code-len 12``, by the host codec."""
    path = str(tmp_path_factory.mktemp("capped") / "capped.dcz")
    assert pcli.main(["compress", src, path, "1", "--format", "2", "--codebook-mode", "fast",
                      "--max-code-len", str(CAP), "--backend", "cpu", "--no-verify"]) == 0
    return path


def test_cli_decompress_backend_gpu_runs_plain_k3(src, capped, tmp_path, monkeypatch):
    """``decompress --backend gpu`` on the plain versions: K3's plain
    version once a chunk, no kernel launch and no host route."""
    out = str(tmp_path / "out")
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    before = _calls()
    assert pcli.main(["decompress", capped, out, "1", "--backend", "gpu"]) == 0
    delta = _delta(before)
    assert delta["decode"] == (0, 2) and delta["decode_routes"] == 0
    assert all(v == (0, 0) for name, v in delta.items() if name not in
               ("decode", "encode_routes", "decode_routes"))
    assert _read(out) == _read(src)


@pytest.mark.parametrize("verb", ["verify", "resume"])
def test_cli_backend_cpu_on_a_port_file(src, capped, tmp_path, monkeypatch, capsys, no_cuda,
                                        verb):
    """``verify --backend cpu --deep`` and ``resume --backend cpu`` (after
    chunk 0, its format and mode from the environment as the verb takes
    them) on the port's file, with no CUDA device: the host codec, no op of
    the port, and the resumed file equals the one-shot one."""
    before = _calls()
    if verb == "verify":
        assert pcli.main(["verify", capped, "1", "--deep", "--backend", "cpu"]) == 0
        assert f"{capped}: OK" in capsys.readouterr().out
    else:
        monkeypatch.setenv("DATACOMP_COMPRESSION_FORMAT_VERSION", "2")
        monkeypatch.setenv("DATACOMP_COMPRESSION_CODEBOOK_MODE", "fast")
        monkeypatch.setenv("DATACOMP_COMPRESSION_MAX_CODE_LEN", str(CAP))
        full = _read(capped)
        header, _ = read_container(capped)
        dcz = str(tmp_path / "cut.dcz")
        with open(dcz + pipeline.PARTIAL_SUFFIX, "wb") as f:
            pipeline._write_partial_header(f, header)
            pipeline._append_partial_chunk(f, header.chunks[0])
        with open(dcz, "wb") as f:
            f.write(full[: header.chunks[0].compressed_offset + header.chunks[0].compressed_size])
        assert pcli.main(["resume", src, dcz, "1", "--last-chunk", "0", "--backend", "cpu"]) == 0
        assert _read(dcz) == full and not os.path.exists(dcz + pipeline.PARTIAL_SUFFIX)
    assert all(v in (0, (0, 0)) for v in _delta(before).values())


@pytest.mark.parametrize("sharded", [False, True], ids=["unsharded", "sharded"])
@pytest.mark.parametrize("backend", ["gpu", "auto"])
def test_cli_backend_without_cuda_fails(src, tmp_path, capsys, no_cuda, backend, sharded):
    """No silent CPU: without a CUDA device and with nothing selecting the
    CPU, ``--backend gpu`` and ``auto`` exit non-zero and write no file."""
    extra = ["--sharded"] if sharded else []
    rc = pcli.main(["compress", src, str(tmp_path / "x.dcz"), "1", "--backend", backend, *extra])
    assert rc != 0 and "no CUDA device" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


def _verbs(parser) -> dict:
    return next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction)).choices


def _gpu(values):
    return None if values is None else ["gpu" if v == "tpu" else v for v in values]


JAX_VERBS = sorted(_verbs(jcli.build_parser()))


def test_cli_verbs_match_jax():
    """The same verbs and aliases (an alias names its verb's parser)."""
    jv, pv = _verbs(jcli.build_parser()), _verbs(pcli.build_parser())
    assert sorted(pv) == JAX_VERBS
    for alias, verb in (("c", "compress"), ("d", "decompress")):
        assert jv[alias] is jv[verb] and pv[alias] is pv[verb]


@pytest.mark.parametrize("verb", JAX_VERBS)
def test_cli_surface_matches_jax(verb):
    """Each verb's positionals (in order) and options: the same names,
    actions, nargs, choices (``tpu`` read as ``gpu``), requiredness, types
    (on sample values) and defaults, but ``--format``'s default, whose
    config ``test_cli_compress_config_matches_jax`` compares instead."""
    def actions(parser):
        return {tuple(a.option_strings) or a.dest: a for a in parser._actions
                if not isinstance(a, argparse._HelpAction)}

    jsub, psub = _verbs(jcli.build_parser())[verb], _verbs(pcli.build_parser())[verb]
    j, p = actions(jsub), actions(psub)
    assert [k for k in p if isinstance(k, str)] == [k for k in j if isinstance(k, str)]
    assert set(p) == set(j)
    for key, ja in j.items():
        pa = p[key]
        assert type(pa) is type(ja), key
        assert (pa.dest, pa.nargs, pa.required, pa.metavar) == \
               (ja.dest, ja.nargs, ja.required, ja.metavar), key
        assert _gpu(pa.choices) == _gpu(ja.choices), key
        if key != ("--format",):
            assert pa.default == ja.default, key
        if ja.type is not None:
            for sample in ("12", "auto", "-1"):
                def parse(action):
                    try:
                        return action.type(sample)
                    except ValueError:
                        return ValueError
                assert parse(pa) == parse(ja), (key, sample)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flags", [
    [], ["--sharded"], ["7"], ["--max-code-len", "auto"],
    ["--format", "2", "--codebook-mode", "fast", "--max-code-len", "12"],
    ["--codebook-mode", "device"], ["--sharded", "--max-code-len", "9"],
], ids=["defaults", "sharded", "chunk", "auto", "fast-v2-12", "device", "sharded-9"])
def test_cli_compress_config_matches_jax(monkeypatch, flags):
    """The compression config that ``compress`` builds: format 1 and the
    config's codebook mode by default, format 2 and the device codebook
    under ``--sharded``, and the JAX CLI's ``--max-code-len`` and chunk
    size, as the JAX CLI builds them (caught at its ``load_config``)."""
    seen = []

    def capture(*args, **kwargs):
        seen.append(jconfig.load_config(*args, **kwargs))
        raise _Stop

    monkeypatch.setattr(jcli, "load_config", capture)
    assert jcli.main(["compress", "in.bin", "out.dcz", *flags]) == 1
    want = seen[0].compression
    got = pcli._config(pcli.build_parser().parse_args(["compress", "in.bin", "out.dcz",
                                                       *flags])).compression
    fields = ("chunk_size_mb", "format_version", "codebook_mode", "max_code_len",
              "subblock_symbols")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    assert got.effective_max_code_len() == want.effective_max_code_len()
