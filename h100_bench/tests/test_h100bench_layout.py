"""The benchmark is data: every name in BENCHMARK.json finds its file, every
configuration its encoder file, and nothing the harness runs imports JAX or
the JAX package."""

import ast
import os

import pytest

import tiny
from harness import common

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "radad_tpu"}


def _bench():
    return common.benchmark()


def test_every_metric_is_found_by_name_and_reads_nothing_from_an_empty_run():
    import run as runner

    bench = _bench()
    empty = common.Run(cell={"name": "x"}, config=common.load_config(
        "whisper-base-itw-bf16"), traffic={}, seed=0, seconds=1,
        trace=True, device="cpu", t_start=0.0)
    for m in bench["per_layer"]:
        mod = runner.load_module("metrics", m["name"])
        assert mod.read(empty) is None, m["name"]
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in bench["workloads"]}


def test_every_cell_finds_its_config_traffic_and_driver():
    bench = _bench()
    configs = {c["name"]: c for c in bench["configs"]}
    for cell in bench["workloads"]:
        cfg = common.load_config(cell["config"])
        assert cfg["name"] == cell["config"]
        assert configs[cell["config"]]["file"] == \
            f"h100_bench/configs/{cell['config']}.json"
        tr = common.load_traffic(cell["traffic"])
        assert os.path.exists(os.path.join(
            tiny.BENCH_DIR, "drivers", f"{tr['driver']}.py"))
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric
        e2e = [m for m in bench["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(cell["name"] in m.get("workloads", [cell["name"]])
                   for m in bench["per_layer"])


EXPORTS = ("weights", "features", "segment_flops", "attention", "width",
           "TINY", "PORT")


def test_every_configuration_finds_its_encoder_file_and_its_exports():
    from harness import program

    for c in _bench()["configs"]:
        cfg = common.load_config(c["name"])
        enc = common.encoder(cfg)
        assert os.path.dirname(enc.__file__) == os.path.join(
            tiny.BENCH_DIR, "encoders"), c["name"]
        for name in EXPORTS:
            assert hasattr(enc, name), (c["name"], name)
        assert set(enc.TINY) <= {"architecture", "pipeline"}
        assert program.port_encoder(cfg)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _py_files(sub=""):
    root = os.path.join(tiny.BENCH_DIR, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _py_files():
        for name in _imports(path):
            assert name not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in _py_files("reference"):
        for name in _imports(path):
            assert name in {"torch", "numpy", "wave", "math", "typing",
                            "__future__", "reference"}, (path, name)


def test_the_encoder_files_import_nothing_of_the_program():
    files = list(_py_files("encoders"))
    assert files
    for path in files:
        for name in _imports(path):
            assert name in {"torch", "numpy", "math", "typing",
                            "__future__", "reference"}, (path, name)


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "radad_tpu_torch_x", types.ModuleType(
        "radad_tpu_torch_x"))
    assert "radad_tpu_torch_x" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "radad_tpu.ops", types.ModuleType("x"))
    assert common.forbidden_modules() == ["radad_tpu"]


def test_run_without_a_card_exits_without_a_result(tmp_path):
    import subprocess
    import sys

    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(tiny.BENCH_DIR, "run.py"),
         "--workload", "w2v2-bulk", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
