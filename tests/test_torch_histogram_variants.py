"""K1s and K1p, the A/B variants of K1 (``datacomp_tpu_torch/ops/
histogram_variants.py``), on the CPU.

- K1s is held to its own TPU kernel: the kernel that
  ``tools/ab_hist_pallas_r3.py::make_stacked`` builds, run through
  ``pl.pallas_call(..., interpret=True)`` with the r3 harness's
  reshape/diagonal epilogue, in each of r3's three configurations, exactly.
  K1p's TPU kernel, ``kernel_2d`` in ``tools/ab_hist_pallas_r4.py``, is a
  closure inside that script's ``main()`` and cannot be reached from a test;
  K1p stays held to ``histogram_pallas`` (``tests/test_torch_codebook.py``,
  ``TestHistogramVariants``).
- A numpy model of K1s's kernel (``csrc/histogram_variants.cu``), which
  cannot run here: each lane's private 8- or 16-bit counters packed into
  words (bin s in field s / W of word s % W), counted over its windows of
  ``groups`` vectors, the one-symbol wrap rule of 8-bit counters, and the
  warp's fold in packed words (an 8-bit word split into two halves of 16-bit
  fields, a 16-bit word added whole) into each lane's totals of bins
  ``lane + 32 j``.  The model must equal ``np.bincount`` for every ``groups``
  in 1..16 at both counter widths, on ``zeros`` (every full 8-bit window
  wraps), a near-uniform input (counters at 255, which must not), ``random``
  and ``skewed``, and no packed field may carry into the next.
- The kernel library's build path changes when a header under ``csrc/``
  changes, so an edited header is never served from a stale build.

The kernels themselves are held to the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from datacomp_tpu_torch import ops  # noqa: E402
from datacomp_tpu_torch.ops import _build  # noqa: E402
from datacomp_tpu_torch.utils.testdata import generate_bytes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 32
ROWS = 8  # r3's rows a block, cut to three small blocks here
#: r3's variants as its harness builds them: widening type, groups a dot
R3 = {"stacked": (jnp.int32, 16), "stacked8": (jnp.int32, 8), "stacked-i16": (jnp.int16, 16)}


def _r3():
    spec = importlib.util.spec_from_file_location(
        "ab_hist_pallas_r3", os.path.join(REPO, "tools", "ab_hist_pallas_r3.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def r3_histogram(data: np.ndarray, name: str) -> np.ndarray:
    """r3's kernel on ``data`` through its harness's padding, grid and
    reshape/diagonal epilogue (``run_variant.hist``), in interpret mode."""
    widen, groups_per_dot = R3[name]
    kernel = _r3().make_stacked(ROWS, widen, groups_per_dot)
    n = data.size
    pad = (-n) % (ROWS * 128)
    mat = jnp.asarray(np.concatenate([data, np.zeros(pad, np.uint8)])).reshape(-1, 128)
    acc = pl.pallas_call(
        kernel,
        grid=(mat.shape[0] // ROWS,),
        in_specs=[pl.BlockSpec((ROWS, 128), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((128, 128), lambda i: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((128, 128), jnp.float32),
        interpret=True,
    )(mat)
    c4 = acc.reshape(16, 8, 16, 8)
    hist = jnp.diagonal(c4, axis1=1, axis2=3).sum(-1).reshape(256)
    return np.asarray(hist.astype(jnp.int32).at[0].add(-jnp.int32(pad)))


def _data(kind: str, n: int) -> np.ndarray:
    if kind == "zeros":
        return np.zeros(n, np.uint8)
    if kind == "near-zeros":
        # zeros, and a 1 at the first byte of each of the first 32 vectors of
        # every 16 x 32 vectors: each lane of a 16-group window sees 255 zeros
        # and one 1, so its 8-bit counter of 0 reaches 255
        i = np.arange(n)
        return ((i % (16 * LANES * 16) < LANES * 16) & (i % 16 == 0)).astype(np.uint8)
    if kind == "random":
        return np.random.default_rng(n).integers(0, 256, n).astype(np.uint8)
    return np.frombuffer(generate_bytes(kind, n), np.uint8).copy()


@pytest.mark.parametrize("kind", ["random", "skewed"])
@pytest.mark.parametrize("name", list(R3))
def test_stacked_matches_r3_pallas_kernel(name, kind):
    assert ops.STACKED[name] == (16 if R3[name][1] == 16 else 8,
                                 16 if R3[name][0] == jnp.int16 else 8)
    n = 3 * ROWS * 128
    data = _data(kind, n)
    for valid_len in (n, n - 1000):
        got = ops.histogram_stacked(torch.from_numpy(data), valid_len, *ops.STACKED[name])
        want = r3_histogram(data[:valid_len], name)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(want, np.bincount(data[:valid_len], minlength=256))


def stacked_model(data: np.ndarray, valid_len: int, groups: int, bits: int,
                  wrap_rule: bool = True) -> np.ndarray:
    """K1s's int32[256] result, computed as ``stacked_kernel<bits>`` computes
    it (the windows of all warps at once: a window's counts do not depend on
    which warp takes it); ``wrap_rule=False`` leaves out the one-symbol rule."""
    words = 256 * bits // 32
    field_shift = 24 if bits == 8 else 16
    nvec = valid_len // 16
    vec = data[: nvec * 16].reshape(nvec, 16)
    per_window = groups * LANES
    windows = -(-nvec // per_window)
    row = np.zeros(256, np.int64)
    if windows:
        # lane l of window i takes vectors i * per_window + l + 32 g, g < groups
        v = (np.arange(windows)[:, None, None] * per_window + np.arange(LANES)[None, :, None]
             + LANES * np.arange(groups)[None, None, :])
        valid = v < nvec
        loads = valid.sum(-1)  # (windows, lanes)
        s = np.where(valid[..., None], vec[np.minimum(v, max(nvec - 1, 0))], 0).astype(np.uint32)
        counted = np.broadcast_to(valid[..., None], s.shape)
        # count: word s % W += 1 << (s >> 3 & shift), 32-bit words that wrap
        cnt = np.zeros((windows, LANES, words), np.uint32)
        idx = np.nonzero(counted)
        sym = s[idx]
        np.add.at(cnt, (idx[0], idx[1], sym & (words - 1)),
                  (np.uint32(1) << ((sym >> 3) & field_shift)).astype(np.uint32))
        # the wrap rule: a full 8-bit window of one symbol clears that word
        if wrap_rule and bits == 8 and groups == 16:
            first = s[:, :, 0, 0]
            uniform = (loads == 16) & (s == first[:, :, None, None]).all(axis=(2, 3))
            wi, li = np.nonzero(uniform)
            cnt[wi, li, first[wi, li] & (words - 1)] = 0
            np.add.at(row, first[wi, li], 256)
        # the fold: lane l sums word l + 32 m over the warp's 32 threads
        total = np.zeros((LANES, 256 // LANES), np.int64)
        for m in range(words // LANES):
            w = np.arange(LANES) + LANES * m
            col = cnt[:, :, w]  # (windows, threads, lanes)
            if bits == 8:
                lo = (col & 0x00FF00FF).sum(1, dtype=np.uint32)
                hi = ((col >> 8) & 0x00FF00FF).sum(1, dtype=np.uint32)
                fields = [(m, lo & 0xFFFF), (m + 4, lo >> 16), (m + 2, hi & 0xFFFF),
                          (m + 6, hi >> 16)]
                exact = [(col >> (8 * f)) & 0xFF for f in (0, 2, 1, 3)]
            else:
                lo = col.sum(1, dtype=np.uint32)
                fields = [(m, lo & 0xFFFF), (m + 4, lo >> 16)]
                exact = [col & 0xFFFF, col >> 16]
            for (j, packed), unpacked in zip(fields, exact):
                # no packed field carried into the next
                assert np.array_equal(packed, unpacked.astype(np.int64).sum(1))
                total[:, j] += packed.astype(np.int64).sum(0)
        for j in range(256 // LANES):
            row[np.arange(LANES) + LANES * j] += total[:, j]
    row += np.bincount(data[nvec * 16 : valid_len], minlength=256)
    return row


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("kind", ["zeros", "near-zeros", "random", "skewed"])
def test_stacked_model_matches_bincount(kind, bits):
    n = (1 << 16) + 77
    data = _data(kind, n)
    for groups in range(1, 17):
        for valid_len in (n, n - 12_345 + groups, 15, 0):
            got = stacked_model(data, valid_len, groups, bits)
            assert np.array_equal(got, np.bincount(data[:valid_len], minlength=256)), (
                groups, valid_len)


@pytest.mark.parametrize("kind", ["zeros", "near-zeros"])
def test_stacked_model_needs_the_wrap_rule_only_for_one_symbol(kind):
    """Without the one-symbol rule a full window of zeros wraps its 8-bit
    counters, and the result is wrong; a window whose counters reach 255 and
    no further needs no rule."""
    n = 1 << 14
    data = _data(kind, n)
    without = stacked_model(data, n, 16, 8, wrap_rule=False)
    assert np.array_equal(without, np.bincount(data, minlength=256)) == (kind == "near-zeros")


@pytest.mark.parametrize("k", [3, 5, 64])
def test_partial_plain_path_with_uneven_stripes(k):
    data = _data("skewed", 20_000)
    for valid_len in (20_000, 17, 0):
        got = ops.histogram_partial(torch.from_numpy(data), valid_len, k)
        assert np.array_equal(got.numpy(), np.bincount(data[:valid_len], minlength=256))


def test_editing_a_header_changes_the_library_path(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    headers = sorted(p.name for p in csrc.glob("*.cuh"))
    assert "histogram_core.cuh" in headers
    before = _build.library_path()
    assert _build.library_path() == before
    for name in headers:
        path = csrc / name
        text = path.read_text()
        path.write_text(text + "\n// edited\n")
        assert _build.library_path() != before, name
        path.write_text(text)
        assert _build.library_path() == before
    (csrc / "new.cuh").write_text("#pragma once\n")
    assert _build.library_path() != before
