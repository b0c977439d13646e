"""Cells of BENCHMARK.json, and documents built beside them, cut to a size the
CPU serves in seconds."""

import json

from dczbench import run

#: a cell that BENCHMARK.json does not hold: format 1 with the `java` codebook,
#: the port's defaults, built from fast-v2's document over the same traffic
FORMAT1 = "java-v1.silesia"


def format1_document() -> tuple:
    """(benchmark, cell, configuration, traffic) of :data:`FORMAT1`: fast-v2's
    document with ``format_version`` 1, ``codebook_mode`` and
    ``codebook_rule`` ``java``, and fast-v2's control, a fixed 12-bit cap."""
    bench, cell, config_doc, traffic = run.load_cell("fast-v2.silesia")
    config_doc = json.loads(json.dumps(config_doc))
    config_doc.update(name="java-v1", codebook_rule="java")
    config_doc["compression"].update(format_version=1, codebook_mode="java")
    config_doc["control"]["why"] = "a fixed 12-bit cap in place of the java rule's uncapped codes"
    return bench, dict(cell, name=FORMAT1, config="java-v1"), config_doc, traffic


def load(workload: str) -> tuple:
    """A cell of BENCHMARK.json by name, or :data:`FORMAT1`."""
    return format1_document() if workload == FORMAT1 else run.load_cell(workload)


def cut(document: tuple, files: int = 3, scale: int = 40, chunk_mb: int = 1) -> tuple:
    """A cell's (benchmark, cell, configuration, traffic) cut to a size the
    CPU's plain kernels serve in seconds: 1 MiB chunks, batches of 4 as on
    the card, one round of the traffic's first ``files`` files at
    1/``scale`` of their size."""
    bench, cell, config_doc, traffic = document
    config_doc = json.loads(json.dumps(config_doc))
    config_doc["compression"]["chunk_size_mb"] = chunk_mb
    config_doc["device"] = {"batch_chunks": 4}
    traffic = dict(traffic, pool_bytes=65536, rounds=1,
                   files=[dict(f, bytes=max(9000, int(f["bytes"]) // scale))
                          for f in traffic["files"][:files]])
    return bench, cell, config_doc, traffic


def small_cell(workload: str, **sizes):
    """:func:`cut` of the cell ``workload`` (:func:`load`)."""
    return cut(load(workload), **sizes)


def cpu_run(workload: str, seed: int = 2**31 + 77, control: bool = False, **sizes):
    bench, cell, config_doc, traffic = small_cell(workload, **sizes)
    return run.run_cell(workload, bench, config_doc, traffic, seed, 600.0, trace=False,
                        device="cpu", control=control)
