"""The judge finds each fault the timed path can have.

``test_run_with_fault_is_incorrect`` drives a whole run on the CPU (the
kernels' plain versions, past the harness's look for a card) with the
program's codec broken underneath, and sees ``correct`` come out false; the
sound run and the control are its two ends.  The other tests hold one
request's capture, tampered with, against the reference."""

import dataclasses
import hashlib
import os

import numpy as np
import pytest

from dczbench import judge
from dczbench.reference import expected_file
from datacomp_tpu_torch.services.gpu_service import GpuChunkCodec

from .helpers import FORMAT1, cpu_run


def _flip_payload_bit(enc, data):
    b = bytearray(enc.payload)
    b[len(b) // 2] ^= 0x10
    return dataclasses.replace(enc, payload=bytes(b))


def _wrong_code_length(enc, data):
    lengths = enc.code_lengths.copy()
    used = np.flatnonzero(lengths)
    lengths[used[0]] += 1
    return dataclasses.replace(enc, code_lengths=lengths)


def _wrong_sha(enc, data):
    return dataclasses.replace(enc, sha256=hashlib.sha256(b"not the chunk").digest())


def _stored_raw(enc, data):
    return dataclasses.replace(enc, payload=data.tobytes(),
                               code_lengths=np.zeros(256, np.int32), gap_bits=None)


ENCODE_FAULTS = {"payload_bit": _flip_payload_bit, "code_length": _wrong_code_length,
                 "sha256": _wrong_sha, "raw_store": _stored_raw}


def _break_encode(monkeypatch, fault):
    sound = GpuChunkCodec.encode_chunk_batch

    def broken(self, datas, metrics):
        out = sound(self, datas, metrics)
        if fault == "half_batch":  # the group's second half gets the first half's chunks
            half = len(out) // 2
            return out[:half] + out[:len(out) - half] if half else out
        return [ENCODE_FAULTS[fault](out[0], datas[0])] + out[1:]

    monkeypatch.setattr(GpuChunkCodec, "encode_chunk_batch", broken)


def _break_decode(monkeypatch):
    sound = GpuChunkCodec.decode_chunk_batch

    def broken(self, payloads, metas, header, metrics):
        out = sound(self, payloads, metas, header, metrics)
        first = out[0].copy()
        first[first.size // 3] ^= 1
        return [first] + out[1:]

    monkeypatch.setattr(GpuChunkCodec, "decode_chunk_batch", broken)


class _EqualToAny(bytes):
    """A digest that equals every other: the check on restore taken out."""

    def __eq__(self, other):
        return True

    def __ne__(self, other):
        return False

    __hash__ = bytes.__hash__


def _break_verify(monkeypatch):
    from datacomp_tpu_torch.services import pipeline

    monkeypatch.setattr(pipeline, "compute_sha256", lambda data: _EqualToAny(32))


def _faults(result):
    return {k: v["value"] for k, v in result["checks"].items() if v["value"]}


@pytest.mark.parametrize("workload", ["fast-v2.silesia", "device-v2.silesia", FORMAT1])
def test_sound_run_is_correct(tmp_tmpdir, workload):
    result = cpu_run(workload)
    assert result["correct"], _faults(result)
    assert result["attempted"] == 3 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", ["fast-v2.silesia", "device-v2.silesia", FORMAT1])
def test_control_is_incorrect(tmp_tmpdir, workload):
    result = cpu_run(workload, control=True)
    assert not result["correct"]
    assert _faults(result)["codebook_faults"] > 0


@pytest.mark.parametrize("workload", ["fast-v2.silesia", FORMAT1])
@pytest.mark.parametrize("fault", [*ENCODE_FAULTS, "half_batch", "restored_byte",
                                   "verify_removed"])
def test_run_with_fault_is_incorrect(tmp_tmpdir, monkeypatch, fault, workload):
    if fault == "restored_byte":
        _break_decode(monkeypatch)
    elif fault == "verify_removed":
        _break_verify(monkeypatch)
    else:
        _break_encode(monkeypatch, fault)
    result = cpu_run(workload, files=2, scale=20)
    assert not result["correct"], fault
    assert _faults(result)
    if fault == "verify_removed":  # the restored bytes are right: only this check sees it
        assert _faults(result) == {"verify_faults": 1}


# -- the judge alone, on one request ------------------------------------------


@pytest.fixture(scope="module")
def served_request(tmp_path_factory):
    """A 2.5 MB file compressed and restored by the program's host codec in
    the fast-v2 configuration at 1 MiB chunks, its capture and the
    reference's expectation."""
    from datacomp_tpu_torch.config import load_config
    from datacomp_tpu_torch.services import CpuCompressionService

    from dczbench import corpus
    from .helpers import small_cell

    d = tmp_path_factory.mktemp("one")
    _, _, config_doc, traffic = small_cell("fast-v2.silesia", files=2, scale=20)
    data = corpus.make_corpus(traffic, 99, 1 << 20, 4032)[1]
    src, dcz, back = (str(d / n) for n in ("in", "in.dcz", "in.out"))
    with open(src, "wb") as f:
        f.write(data.tobytes())
    svc = CpuCompressionService(load_config(compression=dict(config_doc["compression"],
                                                             chunk_size_mb=1)))
    svc.compress(src, dcz)
    svc.decompress(dcz, back)
    got = judge.capture(dcz, back)
    want = expected_file(data, 1 << 20, config_doc["codebook_rule"], 4032)
    return got, want, "in", int(os.path.getmtime(src) * 1000), svc, dcz


@pytest.fixture
def judged_args(served_request):
    return served_request[:4]


def _judged(got, want, name, mtime):
    return {k: v for k, v in judge.judge_request(got, want, name, mtime, 2).items() if v}


def test_judge_passes_the_sound_request(judged_args):
    assert _judged(*judged_args) == {}


@pytest.mark.parametrize("key, field, expect", [
    ("payload_sha256", "payload", "payload_faults"),
    ("lengths", "lengths", "codebook_faults"),
    ("sha256", "sha", "sha_faults"),
    ("gaps", "gaps", "gap_faults"),
])
def test_judge_finds_a_tampered_chunk(judged_args, key, field, expect):
    got, want, name, mtime = judged_args
    got = {**got, "container": {**got["container"]}}
    chunks = [dict(c) for c in got["container"]["chunks"]]
    c = chunks[1]
    if field == "lengths":
        c["lengths"] = c["lengths"].copy()
        c["lengths"][np.flatnonzero(c["lengths"])[0]] += 1
    elif field == "gaps":
        c["gaps"] = c["gaps"].copy()
        c["gaps"][-1] += 1
    else:
        c[key] = bytes(32)
    got["container"]["chunks"] = chunks
    assert expect in _judged(got, want, name, mtime)


def test_judge_finds_a_wrong_raw_store_decision(judged_args):
    got, want, name, mtime = judged_args
    got = {**got, "container": {**got["container"]}}
    chunks = [dict(c) for c in got["container"]["chunks"]]
    chunks[0].update(lengths=np.zeros(256, np.int64), size=chunks[0]["orig_size"])
    got["container"]["chunks"] = chunks
    assert "raw_store_faults" in _judged(got, want, name, mtime)


def test_judge_finds_a_changed_restored_byte(judged_args):
    got, want, name, mtime = judged_args
    size, _ = got["restored"]
    assert "restore_faults" in _judged({**got, "restored": (size, bytes(32))}, want, name, mtime)


def test_judge_counts_failed_requests(judged_args):
    _, want, name, mtime = judged_args
    assert _judged(None, want, name, mtime) == {"failed_requests": 1}


@pytest.mark.parametrize("draw", [0, 1, 2])
def test_verify_check_passes_a_restore_that_checks_digests(served_request, tmp_path, draw):
    svc, dcz = served_request[4:]
    kept = tmp_path / "kept.dcz"
    kept.write_bytes(open(dcz, "rb").read())
    rng = np.random.default_rng(draw)
    assert judge.verify_faults(svc.decompress, str(kept), str(tmp_path / "out"), rng) == 0


def test_verify_check_finds_a_restore_that_does_not(served_request, tmp_path):
    svc, dcz = served_request[4:]
    kept = tmp_path / "kept.dcz"
    kept.write_bytes(open(dcz, "rb").read())
    rng = np.random.default_rng(0)
    assert judge.verify_faults(lambda src, dst: None, str(kept), str(tmp_path / "o"), rng) == 1
    assert judge.verify_faults(svc.decompress, str(tmp_path / "missing.dcz"),
                               str(tmp_path / "o"), rng) == 1
