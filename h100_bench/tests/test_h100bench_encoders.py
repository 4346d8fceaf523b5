"""Each encoder lives in one file, ``encoders/<name>.py``, found by name:
its weights and reference embeddings are those the harness made before the
encoders had files, a copy under another name runs a cell or, under a new
kind, builds with no other file edited, and a kind with no file or with a
``PORT`` the port lacks stops a run before any CUDA work."""

import filecmp
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny
from harness import common, program
from harness import weights as W
from reference import encoders as RE
from reference.precision import CONTROL_OF

SEED = 2**31 + 7
# What ``_readings`` reads, taken on the harness as it was before the
# encoders moved into encoder files (commit 7eb517b, where
# ``clip_embeddings`` took no encoder), on the CPU with torch 2.13. The
# sha256 of the tiny configuration's seeded encoder leaves and of its fusion
# weights: one uniform draw and exact float32 scaling, so the same bits on
# any host.
# Fixed tables (Whisper's sinusoids, numpy's float64 sin / cos) and the
# reference's clip embeddings (exact, then the control's rounding: CPU
# convolutions, matmuls and FFTs whose blocking follows the host's
# instruction set) as their sum, norm and last six values, each row of the
# embeddings apart, held to 1e-6.
PARENT = {
    "wav2vec2-base-itw-f32": (
        "99eeb8c89361ecc36bd815ab9fa915a89e537b703b53c92bb5a1513f087aecc9",
        "fb08de108625428327352401e0780346e7a6ef19c895ea50ae71bb62f597181d",
        {},
        {"exact": [
            [435.0934783220291, 29.727043480530384, 1.4162406921386719,
             1.6888105869293213, 1.8778003454208374, 1.8049333095550537,
             2.398709774017334, 1.5334320068359375],
            [450.4078276157379, 30.95831397713595, 1.243648648262024,
             2.02567458152771, 2.4372811317443848, 2.2990808486938477,
             2.2866363525390625, 1.6796720027923584]],
         "control": [
            [435.10660552978516, 29.72811996373792, 1.4168665409088135,
             1.6898267269134521, 1.8786317110061646, 1.8043392896652222,
             2.3999428749084473, 1.5333998203277588],
            [450.41232657432556, 30.95852350820258, 1.2431252002716064,
             2.026505470275879, 2.4358596801757812, 2.298539876937866,
             2.2871038913726807, 1.6777201890945435]]}),
    "whisper-base-itw-bf16": (
        "7db4397168484078350b2e1a9e7c4dff5d89f8d9505efd2703e0cd1bcc51c754",
        "fb08de108625428327352401e0780346e7a6ef19c895ea50ae71bb62f597181d",
        {"pos_embed": [
            9903.765446882648, 154.91933384962923, -0.996138870716095,
            -0.17598801851272583, 0.5850902199745178, 0.8718443512916565,
            0.9618821740150452, 0.9887860417366028]},
        {"exact": [
            [188.19430932216346, 17.15209573114998, 0.6717737913131714,
             2.7020153999328613, 0.9961192011833191, 1.0123481750488281,
             1.8384532928466797, 0.917587161064148],
            [188.19079064950347, 17.152317660974234, 0.6743077039718628,
             2.7197229862213135, 0.9999446868896484, 1.015592336654663,
             1.844243049621582, 0.9079210162162781]],
         "control": [
            [189.885398813989, 17.225796607535173, 0.6847082376480103,
             2.7284629344940186, 1.0300220251083374, 0.965911865234375,
             1.805748462677002, 0.8884373903274536],
            [190.2510658307001, 17.237054060731037, 0.6637220978736877,
             2.734724283218384, 1.0143684148788452, 0.9799239635467529,
             1.8490091562271118, 0.9060335159301758]]}),
}


def _digest(tensors):
    h = hashlib.sha256()
    for k, v in tensors.items():
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def _summary(t):
    f = t.double().reshape(-1)
    return [float(f.sum()), float(f.norm())] + [float(x) for x in f[-6:]]


def _readings(cfg):
    enc = common.encoder(cfg)
    tables = [name for name, _, init in enc.weights(cfg["architecture"])
              if isinstance(init, torch.Tensor)]
    enc_w = W.encoder_weights(cfg, SEED, "cpu")
    fus_w = W.fusion_weights(cfg, SEED, "cpu")
    p = cfg["pipeline"]
    n = int(p["clip_duration"] * p["sample_rate"])
    audio = torch.as_tensor(np.random.default_rng(SEED).standard_normal(
        (2, n), dtype=np.float32) * 0.1)
    control = {s: CONTROL_OF[x] for s, x in cfg["stage_precision"].items()}
    with torch.no_grad():
        emb = {kinds: [_summary(row) for row in RE.clip_embeddings(
                   enc, enc_w, cfg, audio, kinds=k)]
               for kinds, k in (("exact", None), ("control", control))}
    return (_digest({k: v for k, v in enc_w.items() if k not in tables}),
            _digest(fus_w), {k: _summary(enc_w[k]) for k in tables}, emb)


@pytest.mark.parametrize("config", sorted(PARENT))
def test_weights_and_reference_embeddings_are_those_of_the_parent(config):
    drawn, fusion, tables, emb = _readings(tiny.tiny_config(config))
    want = PARENT[config]
    assert (drawn, fusion) == want[:2]
    assert set(tables) == set(want[2])
    torch.testing.assert_close(
        torch.tensor([tables[k] for k in sorted(tables)] + emb["exact"]
                     + emb["control"], dtype=torch.float64),
        torch.tensor([want[2][k] for k in sorted(want[2])]
                     + want[3]["exact"] + want[3]["control"],
                     dtype=torch.float64),
        rtol=1e-6, atol=1e-6)


def test_a_configuration_runs_through_an_encoder_file_found_by_name_only(
        tmp_path, monkeypatch):
    cfg = tiny.tiny_config("wav2vec2-base-itw-f32")
    shutil.copy(os.path.join(common.ENCODERS_DIR, "wav2vec2.py"),
                tmp_path / "wav2vec2.py")
    # the directory holds the copy alone, found by the kind's name
    monkeypatch.setattr(common, "ENCODERS_DIR", str(tmp_path))
    assert common.encoder(cfg).__file__ == str(tmp_path / "wav2vec2.py")
    run = tiny.cpu_run("wav2vec2-base-itw-f32", "bulk-b64", cfg=cfg)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0


WAV2VEC2_PORT = ("wav2vec2", "Wav2Vec2Config", "Wav2Vec2Model")
# the three configurations' list-valued "pipeline" fields: the parent turned
# these, by name, into tuples
PARENT_TUPLES = ("tpp_levels", "wav2vec2_layers_to_use",
                 "detection_hidden_dims")


def _encoder_copy(path, port) -> None:
    """wav2vec2's encoder file at ``path``, its ``PORT`` replaced by
    ``port`` (taken out where ``port`` is ``False``)."""
    with open(os.path.join(common.ENCODERS_DIR, "wav2vec2.py")) as f:
        text = f.read()
    text, n = re.subn(r"^PORT = .*\n", "" if port is False
                      else f"PORT = {port!r}\n", text, flags=re.M)
    assert n == 1
    with open(path, "w") as f:
        f.write(text)


def _bench_copy(tmp_path, config: dict, port=None) -> str:
    """A checkout of the harness, with the program beside it and one cell
    of ``config``; where ``port`` is given, wav2vec2's encoder file under
    the name of ``config``'s kind, with that ``PORT``."""
    shutil.copytree(tiny.BENCH_DIR, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    os.symlink(os.path.join(os.path.dirname(tiny.BENCH_DIR),
                            "radad_tpu_torch"), tmp_path / "radad_tpu_torch")
    if port is not None:
        _encoder_copy(tmp_path / "h100_bench" / "encoders"
                      / f"{config['encoder']}.py", port)
    with open(tmp_path / "h100_bench" / "configs" / "odd.json", "w") as f:
        json.dump(dict(config, name="odd"), f)
    bench = dict(common.benchmark())
    bench["workloads"] = [{"name": "odd-bulk", "config": "odd",
                           "traffic": "bulk-b64", "chips": 1, "why": "x"}]
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    return str(tmp_path)


@pytest.mark.parametrize("port", [
    None, ("wav2vec2", "Wav2Vec2Config", "NoSuchModel")],
    ids=["no-file", "missing-class"])
def test_a_kind_without_a_file_stops_the_run_without_a_result(
        tmp_path, port):
    """No encoder file, or one whose ``PORT`` names a class the port
    lacks: exit 2 with no result, naming the file, before any CUDA work."""
    cfg = dict(common.load_config("wav2vec2-base-itw-f32"), encoder="nosuch")
    root = _bench_copy(tmp_path, cfg, port)
    proc = subprocess.run(
        [sys.executable, os.path.join("h100_bench", "run.py"), "--workload",
         "odd-bulk", "--seed", str(SEED), "--seconds", "1"],
        capture_output=True, text=True, cwd=root, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""
    assert os.path.join("encoders", "nosuch.py") in proc.stderr, proc.stderr
    assert port is None or "NoSuchModel" in proc.stderr, proc.stderr
    assert "CUDA" not in proc.stderr


_BUILD = """
import json, sys, tempfile
sys.path[:0] = ["h100_bench", "."]
from harness import common, program, weights as W
cfg = common.load_config("odd")
config_cls, model_cls = program.port_encoder(cfg)
pipe = program.build_pipeline(cfg, W.encoder_weights(cfg, 7, "cpu"),
                              W.fusion_weights(cfg, 7, "cpu"), "cpu",
                              tempfile.mkdtemp(), 7)
print(json.dumps([program.__file__, common.encoder(cfg).__file__,
                  config_cls.__name__, model_cls.__name__, pipe.encoder.name,
                  type(pipe.encoder.model).__name__]))
"""


def test_a_new_kind_from_a_copied_encoder_file_builds_with_no_file_edited(
        tmp_path):
    cfg = dict(tiny.tiny_config("wav2vec2-base-itw-f32"), encoder="newkind")
    root = _bench_copy(tmp_path, cfg, WAV2VEC2_PORT)
    copy = os.path.join(root, "h100_bench")
    added = set()
    for d, _, files in os.walk(copy):
        for name in files:
            rel = os.path.relpath(os.path.join(d, name), copy)
            orig = os.path.join(tiny.BENCH_DIR, rel)
            if not os.path.exists(orig):
                added.add(rel)
            else:
                assert filecmp.cmp(orig, os.path.join(copy, rel),
                                   shallow=False), rel
    assert added == {os.path.join("encoders", "newkind.py"),
                     os.path.join("configs", "odd.json")}
    proc = subprocess.run([sys.executable, "-c", _BUILD], capture_output=True,
                          text=True, cwd=root, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == [os.path.join(copy, "harness", "program.py"),
                   os.path.join(copy, "encoders", "newkind.py"),
                   "Wav2Vec2Config", "Wav2Vec2Model", "newkind",
                   "Wav2Vec2Model"]


@pytest.mark.parametrize("port,says", [
    (False, "PORT is None"),
    (("wav2vec2", "Wav2Vec2Model"), "PORT is ("),
    (("wav2vec2.x", "Wav2Vec2Config", "Wav2Vec2Model"), "PORT is ("),
    (("nosuch", "Wav2Vec2Config", "Wav2Vec2Model"),
     "radad_tpu_torch.models.nosuch, which the port does not have"),
    (("wav2vec2", "NoSuchConfig", "Wav2Vec2Model"), ".NoSuchConfig, which"),
    (("wav2vec2", "Wav2Vec2Config", "extract_features"),
     ".extract_features, which"),
    (("wav2vec2", "Wav2Vec2Config", "Wav2Vec2Config"), "not an nn.Module"),
], ids=["missing", "short", "dotted", "no-module", "no-config-class",
        "not-a-class", "not-a-module"])
def test_a_port_the_program_lacks_is_refused_naming_the_encoder_file(
        tmp_path, monkeypatch, port, says):
    kind = f"odd_{abs(hash(repr(port)))}"
    _encoder_copy(tmp_path / f"{kind}.py", port)
    monkeypatch.setattr(common, "ENCODERS_DIR", str(tmp_path))
    with pytest.raises(ValueError) as e:
        program.port_encoder({"name": "odd", "encoder": kind})
    assert str(tmp_path / f"{kind}.py") in str(e.value)
    assert says in str(e.value), str(e.value)


def test_the_harness_builds_every_encoder_kind_of_the_port():
    """Every encoder file's ``PORT`` resolves; where the port's factory
    has that kind, to the config class it uses."""
    from radad_tpu_torch.models import encoder

    kinds = sorted(f[:-3] for f in os.listdir(common.ENCODERS_DIR)
                   if f.endswith(".py"))
    assert kinds
    for kind in kinds:
        config_cls, model_cls = program.port_encoder(
            {"name": kind, "encoder": kind})
        assert issubclass(model_cls, torch.nn.Module)
        if kind in encoder._CONFIGS:
            assert config_cls is encoder._CONFIGS[kind]


@pytest.mark.parametrize("config", ["wav2vec2-base-itw-f32",
                                    "whisper-base-itw-bf16",
                                    "wavlm-large-itw-bf16"])
def test_every_list_of_the_pipeline_is_a_tuple_as_the_parent_made_them(
        config, tmp_path):
    from radad_tpu_torch.config import Config

    cfg = common.load_config(config)
    assert {k for k, v in cfg["pipeline"].items()
            if isinstance(v, list)} == set(PARENT_TUPLES)
    root = str(tmp_path)
    parent = Config().replace(
        data_root=root, vector_db_path=os.path.join(root, "vdb"),
        train_data_path=root, test_data_path=root, random_seed=7,
        **{k: (tuple(v) if k in PARENT_TUPLES else v)
           for k, v in cfg["pipeline"].items()})
    assert program.program_config(cfg, root, 7) == parent
