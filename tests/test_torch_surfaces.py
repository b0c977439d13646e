"""The port's surfaces on the CPU: the dashboard and its HTML report against
the JAX package's on the same metrics (apart from the title and the device
lines), the four-view terminal app's key state machine, settings and a
``cpu`` compress, and the CLI verbs ``gen`` (the JAX ``gen``'s bytes),
``resume`` (a one-shot compress's bytes), ``config``, ``stats``,
``dashboard`` and ``bench`` (the card-only benches refuse the CPU)."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import datacomp_tpu.cli as jcli
import datacomp_tpu.models as jmodels
import datacomp_tpu.ui as jui
import datacomp_tpu_torch.config as pconfig
import datacomp_tpu_torch.models as pmodels
import datacomp_tpu_torch.ui as pui
from datacomp_tpu_torch import cli as pcli
from datacomp_tpu_torch.core import read_container
from datacomp_tpu_torch.services import pipeline
from datacomp_tpu_torch.ui import app, dashboard
from datacomp_tpu_torch.utils.testdata import generate_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _metrics(models):
    ms = models.MetricsService()
    for i in range(5):
        ms.add_metrics(models.CompressionMetrics(
            f"file{i}.bin", models.OperationType.COMPRESSION, 1000 * (i + 1), 400 * (i + 1),
            0.01 * (i + 1), "CPU" if i % 2 else "GPU"))
    return ms


def _without_device(text: str, title: str) -> list:
    """The dashboard's lines without its title and its device lines."""
    return [line for line in text.replace(title, "TITLE").splitlines()
            if not line.startswith(("Device:", "Backend:", "           …"))]


@pytest.mark.parametrize("populated", [False, True])
def test_dashboard_matches_jax(populated):
    p = _metrics(pmodels) if populated else pmodels.MetricsService()
    j = _metrics(jmodels) if populated else jmodels.MetricsService()
    ptext, jtext = pui.render_dashboard(p), jui.render_dashboard(j)
    assert ptext.splitlines()[0] == dashboard.TITLE
    assert _without_device(ptext, dashboard.TITLE) == \
        _without_device(jtext, "datacomp-tpu dashboard")
    assert ("No operations recorded" in ptext) != populated


def test_dashboard_device_lines(monkeypatch):
    """Without a card the dashboard says so, and catches nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lines = dashboard.device_info_lines()
    assert "Device:    no CUDA devices available" in lines
    assert f"Backend:   torch {torch.__version__}, CUDA {torch.version.cuda}" in lines


@pytest.mark.parametrize("theme", ["dark", "light", "auto"])
def test_html_matches_jax(tmp_path, theme):
    p, j = str(tmp_path / "p.html"), str(tmp_path / "j.html")
    pui.export_html(p, _metrics(pmodels), theme=theme)
    jui.export_html(j, _metrics(jmodels), theme=theme)
    with open(p) as fp, open(j) as fj:
        ptext, jtext = fp.read(), fj.read()
    assert ptext.count('class="bar"') == 5 and "file0.bin" in ptext
    # the one line that holds the device info differs; so does the title
    keep = [line for line in ptext.replace(dashboard.TITLE, "TITLE").splitlines()
            if not line.startswith("<p>")]
    assert keep == [line for line in jtext.replace("datacomp-tpu dashboard", "TITLE").splitlines()
                    if not line.startswith("<p>")]
    assert {"dark": "--bg:#14151a", "light": "--bg:#f7f7f5",
            "auto": "prefers-color-scheme"}[theme] in ptext


def test_html_bad_theme_and_sparkline(tmp_path):
    with pytest.raises(ValueError, match="sepia"):
        pui.export_html(str(tmp_path / "r.html"), _metrics(pmodels), theme="sepia")
    assert pui.sparkline([]) == ""
    values = [0.0, 1.0, 2.0, 4.0]
    assert pui.sparkline(values) == jui.sparkline(values)
    assert len(pui.sparkline(values)) == 4 and pui.sparkline(values)[-1] == "█"
    assert len(pui.sparkline(list(range(100)), width=40)) == 40


def test_app_views_and_keys():
    st = app.AppState()
    for key, name in zip("1234", ("dashboard", "Compress", "Benchmark", "Settings")):
        app.handle_key(st, key)
        assert name in "\n".join(app.render_view(st))
    app.handle_key(st, "2")
    for ch in "/no/such/file":
        app.handle_key(st, ch)
    assert st.input_path == "/no/such/file"
    app.handle_key(st, app.KEY_BACKSPACE)
    assert st.input_path == "/no/such/fil"
    app.handle_key(st, app.KEY_TAB)
    assert st.field_focus == 1
    app.handle_key(st, "x")
    assert st.output_path == "x"
    app.handle_key(st, app.KEY_TAB)
    app.handle_key(st, app.KEY_ENTER)  # a missing file: a message, no thread
    assert "not found" in st.op.message
    app.handle_key(st, "q")
    assert st.quit


def test_app_settings_cycle_and_save(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    st = app.AppState()
    app.handle_key(st, "4")
    app.handle_key(st, app.KEY_RIGHT)  # chunk 16 -> 32
    assert st.settings["chunk_size_mb"] == "32"
    app.handle_key(st, app.KEY_DOWN)
    app.handle_key(st, app.KEY_RIGHT)  # format 2 -> 1
    assert st.settings["format_version"] == "1"
    app.handle_key(st, app.KEY_DOWN)
    app.handle_key(st, app.KEY_DOWN)
    seen = []
    for _ in range(3):
        app.handle_key(st, app.KEY_RIGHT)
        seen.append(st.settings["backend"])
    assert seen == ["cpu", "gpu", "auto"]
    app.handle_key(st, "s")
    assert "saved" in st.settings_saved
    cfg = pconfig.load_config(str(tmp_path / "datacomp.toml"))
    assert cfg.compression.chunk_size_mb == 32
    assert cfg.compression.format_version == 1


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_app_compress_runs(tmp_path, monkeypatch, backend):
    """A compress from the Compress view: the host codec, and the GPU service
    on the kernels' plain versions."""
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    src = tmp_path / "ui.bin"
    src.write_bytes(generate_bytes("text", 200_000))
    st = app.AppState()
    st.settings.update(backend=backend, chunk_size_mb="1", codebook_mode="fast")
    app.handle_key(st, "2")
    st.input_path = str(src)
    worker = app.start_operation(st)
    worker.join(timeout=120)
    assert not worker.is_alive()
    assert st.op.message.startswith("done:"), st.op.message
    assert (tmp_path / "ui.bin.dcz").exists()
    text = "\n".join(app.render_view(st))
    assert "MB/s" in st.op.message and "Encoding" in text  # stage breakdown


def test_app_gpu_backend_without_a_card_reports(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DATACOMP_DEVICE_PLATFORM", raising=False)
    src = tmp_path / "ui.bin"
    src.write_bytes(b"abc" * 1000)
    st = app.AppState()
    st.settings["backend"] = "gpu"
    st.input_path = str(src)
    app.start_operation(st).join(timeout=60)
    assert st.op.message.startswith("error: no CUDA device")


def run(argv, capsys) -> tuple:
    rc = pcli.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("args", [["1"], ["2", "--compressible"], ["1", "--corpus"]])
def test_gen_writes_jax_bytes(tmp_path, capsys, args):
    p, j = str(tmp_path / "p"), str(tmp_path / "j")
    size, *flags = args
    assert pcli.main(["gen", size, p, *flags]) == 0
    assert jcli.main(["gen", size, j, *flags]) == 0
    out = capsys.readouterr().out
    assert "Generated" in out
    if "--corpus" in flags:
        names = sorted(os.listdir(p))
        assert names == sorted(os.listdir(j)) and len(names) == 7
        pairs = [(os.path.join(p, n), os.path.join(j, n)) for n in names]
    else:
        pairs = [(p, j)]
    for a, b in pairs:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


def test_resume_equals_one_shot(tmp_path, capsys, monkeypatch):
    """``resume`` after chunk 1 of four writes the one-shot ``.dcz`` byte for
    byte, the format and mode from the environment as the verb takes them."""
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    monkeypatch.setenv("DATACOMP_COMPRESSION_FORMAT_VERSION", "2")
    monkeypatch.setenv("DATACOMP_COMPRESSION_CODEBOOK_MODE", "fast")
    src = tmp_path / "r.bin"
    src.write_bytes(generate_bytes("text", 4 << 20))
    one_shot = str(tmp_path / "one.dcz")
    rc, _, err = run(["compress", str(src), one_shot, "1", "--format", "2", "--codebook-mode",
                      "fast", "--no-verify"], capsys)
    assert rc == 0, err
    with open(one_shot, "rb") as f:
        full = f.read()
    header, _ = read_container(one_shot)
    assert header.version == 2 and len(header.chunks) == 4
    dcz = str(tmp_path / "cut.dcz")
    with open(dcz + pipeline.PARTIAL_SUFFIX, "wb") as f:
        pipeline._write_partial_header(f, header)
        for c in header.chunks[:2]:
            pipeline._append_partial_chunk(f, c)
    with open(dcz, "wb") as f:
        f.write(full[: header.chunks[1].compressed_offset + header.chunks[1].compressed_size])
    rc, out, err = run(["resume", str(src), dcz, "1", "--last-chunk", "1", "--stages"], capsys)
    assert rc == 0, err
    assert "Compression complete" in out and "Encoding" in out
    assert not os.path.exists(dcz + pipeline.PARTIAL_SUFFIX)
    with open(dcz, "rb") as f:
        assert f.read() == full


def test_resume_takes_the_jax_arguments():
    """The verb's arguments are the JAX verb's, ``--backend`` included."""
    def options(parser):
        sub = next(a for a in parser._actions if a.dest == "command").choices["resume"]
        return {a.dest for a in sub._actions} - {"help"}

    assert options(pcli.build_parser()) == options(jcli.build_parser())


def test_config_template_round_trips(tmp_path, capsys):
    path = str(tmp_path / "datacomp.toml")
    rc, out, _ = run(["config", "--init", path], capsys)
    assert rc == 0 and "Wrote config template" in out
    assert pconfig.load_config(path) == pconfig.AppConfig()
    import tomllib

    with open(path, "rb") as f:
        table = tomllib.load(f)["datacomp"]
    for name, section in vars(pconfig.AppConfig()).items():
        assert {k.replace("-", "_") for k in table[name]} == set(vars(section)), name
    assert "histogram-backend" not in pcli.TEMPLATE_TOML
    # fallback-on-error is read only to refuse true; auto-detect = false is
    # read as force-cpu and has no key of its own
    assert "fallback-on-error = false" in pcli.TEMPLATE_TOML
    assert "auto-detect" not in pcli.TEMPLATE_TOML
    rc, _, err = run(["config", "--init", path], capsys)
    assert rc == 1 and "exists" in err
    assert run(["config", "--init", path, "--force"], capsys)[0] == 0
    rc, out, _ = run(["config", "--file", path], capsys)
    assert rc == 0
    for section in ("[compression]", "[device]", "[benchmark]", "[logging]", "[output]"):
        assert section in out
    assert "measurement_iterations = 5" in out


def test_stats_in_a_fresh_process():
    res = subprocess.run([sys.executable, "-m", "datacomp_tpu_torch.cli", "stats"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "No operations recorded in this session"


def test_stats_lists_this_process(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(pmodels.MetricsService, "_instance", None)
    src = tmp_path / "s.bin"
    src.write_bytes(generate_bytes("text", 100_000))
    monkeypatch.setenv("DATACOMP_DEVICE_FORCE_CPU", "1")
    assert run(["compress", str(src), str(tmp_path / "s.dcz"), "1"], capsys)[0] == 0
    rc, out, _ = run(["stats"], capsys)
    assert rc == 0 and "s.bin: Compression 100,000 B @ " in out and "[CPU]" in out


def test_dashboard_verb(tmp_path, capsys):
    html = str(tmp_path / "d.html")
    rc, out, _ = run(["dashboard", "--html", html, "--theme", "light"], capsys)
    assert rc == 0
    assert dashboard.TITLE in out and f"HTML report written to {html}" in out
    with open(html) as f:
        assert "--bg:#f7f7f5" in f.read()


@pytest.mark.parametrize("flag", ["--kernels", "--batched"])
def test_bench_device_benches_refuse_the_cpu(capsys, monkeypatch, flag):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(["bench", flag, "--size-mb", "1"], capsys)
    assert rc == 1 and "needs a CUDA device" in err and not out


def test_bench_suite_verb(capsys, monkeypatch):
    monkeypatch.setenv("DATACOMP_DEVICE_PLATFORM", "cpu")
    monkeypatch.setenv("DATACOMP_BENCHMARK_WARMUP_ITERATIONS", "0")
    monkeypatch.setenv("DATACOMP_BENCHMARK_MEASUREMENT_ITERATIONS", "1")
    monkeypatch.setenv("DATACOMP_COMPRESSION_CHUNK_SIZE_MB", "1")
    rc, out, err = run(["bench", "--size-mb", "1", "--format-out", "csv"], capsys)
    assert rc == 0, err
    lines = out.strip().splitlines()
    assert lines[0].startswith("service,operation") and len(lines) == 5
    assert {line.split(",")[0] for line in lines[1:]} == {"CPU", "GPU (plain PyTorch on the CPU)"}


def test_bench_corpus_verb(tmp_path, capsys):
    corpus = str(tmp_path / "c")
    assert pcli.main(["gen", "1", corpus, "--corpus"]) == 0
    capsys.readouterr()
    rc, out, err = run(["bench", "--corpus", corpus, "--format-out", "json"], capsys)
    assert rc == 0, err
    report = json.loads(out)
    assert report["backend"] == "cpu" and len(report["files"]) == 7
    assert report["format_version"] == 1 and report["codebook_mode"] == "java"


def test_app_bench_view_runs(monkeypatch):
    """The Benchmark view runs the port's suite (host codec alone here)."""
    monkeypatch.setenv("DATACOMP_DEVICE_FORCE_CPU", "1")
    st = app.AppState()
    app.handle_key(st, "3")
    worker = app.start_benchmark(st)
    deadline = time.time() + 120
    while st.bench_running and time.time() < deadline:
        time.sleep(0.05)
    worker.join(timeout=1)
    assert not st.bench_running, "the benchmark did not finish"
    assert "Benchmark Results" in st.bench_text and "CPU" in st.bench_text
