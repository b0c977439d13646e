"""K4: the canonical-Huffman codebook built on the device, as a CUDA kernel
and as plain PyTorch.

Counterpart of ``datacomp_tpu/ops/codebook.py::device_codebook``
(``device_code_lengths`` then ``device_canonical_codes``), equal to it tie
for tie: int32[256] lengths and uint32[256] canonical codes from an
int32[256] histogram.  The lengths are optimal and uncapped; lengths above 32
are exact, their codes meaningless.  The kernel is ``csrc/codebook.cu``; it
carries weights in 32 bits, exact while the histogram's total is at most
2^32 - 2 (any chunk below 2^31 bytes), where the plain version's are 64-bit.
"""

from __future__ import annotations

import torch

from . import _build

NSYM = 256
#: deepest code that gets a canonical codeword (the format's 32-bit codes)
MAX_LEN = 32
#: key of an absent symbol: above any sum of frequencies
_INF = 1 << 62
_MASK32 = 0xFFFFFFFF

kernel_launches = _build.LaunchCounter()
reference_calls = _build.LaunchCounter()


def _merge_depths(leaf_freqs: list, nsym: int) -> list:
    """Depths of the ``nsym`` present leaves, in leaf order, from the
    two-queue merge that takes a leaf on a tie."""
    parent = [-1] * (2 * NSYM - 1)  # leaf slot k -> node k; internal m -> 256 + m
    intern: list = []
    li = ii = 0
    for _ in range(nsym - 1):
        ids, total = [], 0
        for _ in range(2):
            lf = leaf_freqs[li] if li < NSYM else _INF
            itf = intern[ii] if ii < len(intern) else _INF
            if lf <= itf:
                ids.append(li)
                li += 1
                total += lf
            else:
                ids.append(NSYM + ii)
                ii += 1
                total += itf
        parent[ids[0]] = parent[ids[1]] = NSYM + len(intern)
        intern.append(total)
    depth = [0] * (2 * NSYM - 1)
    for m in range(nsym - 3, -1, -1):  # the root, 256 + nsym - 2, has depth 0
        depth[NSYM + m] = depth[parent[NSYM + m]] + 1
    return [depth[parent[k]] + 1 for k in range(nsym)]


def codebook_reference(hist: torch.Tensor):
    """Plain PyTorch: a stable sort of the keys, the merge as a loop on the
    host, and the canonical codes computed over the whole table at once."""
    reference_calls.add()
    dev = hist.device
    freqs = hist.to(torch.int64)
    present = freqs > 0
    nsym = int(present.sum())
    keys = torch.where(present, freqs, torch.full_like(freqs, _INF))
    leaf_freqs, leaf_syms = torch.sort(keys, stable=True)  # by (freq, symbol)
    lengths = torch.zeros(NSYM, dtype=torch.int64, device=dev)
    if nsym == 1:
        lengths = present.to(torch.int64)
    elif nsym > 1:
        depths = _merge_depths(leaf_freqs.tolist(), nsym)
        lengths[leaf_syms[:nsym]] = torch.tensor(depths, dtype=torch.int64, device=dev)

    counted = (lengths > 0) & (lengths <= MAX_LEN)
    counts = torch.bincount(lengths[counted], minlength=MAX_LEN + 1).tolist()
    first, code = [0] * (MAX_LEN + 1), 0
    for ln in range(1, MAX_LEN + 1):
        code = ((code + counts[ln - 1]) << 1) & _MASK32
        first[ln] = code
    sym = torch.arange(NSYM, device=dev)
    same_len_before = (
        (lengths[None, :] == lengths[:, None]) & (sym[None, :] < sym[:, None])
    ).sum(1)
    first_t = torch.tensor(first, dtype=torch.int64, device=dev)
    codes = torch.where(
        lengths > 0, (first_t[lengths.clamp(max=MAX_LEN)] + same_len_before) & _MASK32, 0
    )
    return lengths.to(torch.int32), codes.to(torch.uint32)


def codebook(hist: torch.Tensor):
    """``(lengths int32[256], codes uint32[256])`` from an int32[256] histogram.

    A CUDA tensor launches the kernel (the outputs stay on the device, for the
    encoder); a CPU tensor takes the plain version.
    """
    _build.check_tensor(hist, "hist", torch.int32, NSYM)
    if _build.on_cpu(hist):
        return codebook_reference(hist)
    lengths = torch.empty(NSYM, dtype=torch.int32, device=hist.device)
    codes = torch.empty(NSYM, dtype=torch.uint32, device=hist.device)
    lib = _build.library()
    with torch.cuda.device(hist.device):
        rc = lib.dcz_codebook(hist.data_ptr(), lengths.data_ptr(), codes.data_ptr(),
                              _build.stream(hist))
    _build.check(rc, "codebook")
    kernel_launches.add()
    return lengths, codes
