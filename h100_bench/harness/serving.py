"""Set-up and check shared by the serving drivers.

Set-up: the clips (the DB's and a pool of fresh ones) written into the
run's directory under TMPDIR; the weights made on the device; the DB rows
(``rows.serving_rows`` around the reference's embeddings of the DB clips);
the pipeline built with those weights and the rows added to its index.

Check: after the window, with the program freed, a sample of the window's
answers drawn from the seed is judged (``check.judge_serving``).
"""

from __future__ import annotations

import gc
import os
import shutil
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from harness import check, clips, program, rows as R, weights as W
from harness.common import Run, encoder, file_id, scratch_dir, sub_seed
from reference import audio as RA
from reference import encoders as RE
from reference import fusion as RF
from reference import search as RS
from reference.precision import OWN_KIND


@dataclass
class Serving:
    pipe: object
    scratch: str
    db_paths: List[str]
    db_labels: List[float]
    pool: List[str]
    anchors: torch.Tensor  # the reference's DB clip embeddings, on the host


def _audio(config: dict, paths: List[str], device) -> torch.Tensor:
    p = config["pipeline"]
    sr = p["sample_rate"]
    n = int(p["clip_duration"] * sr)
    return torch.as_tensor(np.stack([RA.read_clip(x, n, sr) for x in paths]),
                           device=device)


def reference_embeddings(config, enc_w, paths, device, kinds=None):
    return RE.clip_embeddings(encoder(config), enc_w, config,
                              _audio(config, paths, device), kinds=kinds)


def inputs(run: Run, enc_w=None) -> Serving:
    """The clips and the DB clips' reference embeddings; no program."""
    cfg, tr, dev = run.config, run.traffic, run.device
    scratch = scratch_dir(run.cell["name"])
    rng = np.random.default_rng(sub_seed(run.seed, "clips"))
    db_paths, db_labels = clips.write(scratch, "db", cfg["db_clips"], rng)
    pool, _ = clips.write(scratch, "pool", tr["pool"], rng)
    if enc_w is None:
        enc_w = W.encoder_weights(cfg, run.seed, dev)
    with torch.no_grad():
        anchors = reference_embeddings(cfg, enc_w, db_paths, dev)
    return Serving(None, scratch, db_paths, db_labels, pool, anchors)


def setup(run: Run) -> Serving:
    cfg, dev = run.config, run.device
    enc_w = W.encoder_weights(cfg, run.seed, dev)
    sv = inputs(run, enc_w)
    rows, labels, names = R.serving_rows(
        sv.anchors, [os.path.basename(p) for p in sv.db_paths], sv.db_labels,
        cfg["index_rows"], run.seed)
    sv.anchors = sv.anchors.cpu()
    fus_w = W.fusion_weights(cfg, run.seed, dev)
    if dev != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    sv.pipe = program.build_pipeline(cfg, enc_w, fus_w, dev,
                                     os.path.join(sv.scratch, "root"),
                                     run.seed)
    del enc_w, fus_w
    sv.pipe.index.add(rows, labels.tolist(), names)
    del rows, labels
    return sv


def free(sv: Serving, run: Run) -> None:
    """Read the peak, then drop the program's state."""
    if run.device != "cpu":
        torch.cuda.synchronize()
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    sv.pipe = None
    gc.collect()
    if run.device != "cpu":
        torch.cuda.empty_cache()


def judge(run: Run, sv: Serving, answers: List[tuple]) -> dict:
    """``answers``: (path, program embedding [D], payload) of the sampled
    requests. → the compared numbers."""
    cfg, dev = run.config, run.device
    enc_w = W.encoder_weights(cfg, run.seed, dev)
    fus_w = W.fusion_weights(cfg, run.seed, dev)
    names = [os.path.basename(p) for p in sv.db_paths]
    rows, labels, names = R.serving_rows(
        sv.anchors.to(dev), names, sv.db_labels, cfg["index_rows"], run.seed)
    row_of = {nm: i for i, nm in enumerate(names)}
    row_ids = torch.as_tensor([file_id(nm) for nm in names],
                              dtype=torch.int64, device=dev)
    paths = [a[0] for a in answers]
    with torch.no_grad():
        tpp_r = reference_embeddings(cfg, enc_w, paths, dev)
    tpp_p = torch.stack([a[1].float() for a in answers]).to(dev)
    pay = [a[2] for a in answers]
    got = torch.as_tensor([[row_of.get(f, -1) for f in p["retrieved_files"]]
                           for p in pay], device=dev)
    got_d = torch.as_tensor([[r["distance"] for r in p["retrieved"]]
                             for p in pay], device=dev, dtype=torch.float64)
    got_l = torch.as_tensor([p["retrieved_labels"] for p in pay], device=dev)
    logit = torch.as_tensor([p["logit"] for p in pay], device=dev,
                            dtype=torch.float64)
    exclude = torch.as_tensor([file_id(p) for p in paths], device=dev)
    with torch.no_grad():
        return check.judge_serving(
            tpp_p, got, got_d, got_l, logit, tpp_r, rows, row_ids, labels,
            exclude, fus_w, len(cfg["pipeline"]["detection_hidden_dims"]),
            OWN_KIND[cfg["stage_precision"]["fusion"]])


def cleanup(sv: Serving) -> None:
    shutil.rmtree(sv.scratch, ignore_errors=True)


def control_answers(run: Run, sv: Serving, paths: List[str], kinds: dict,
                    fault: str = None) -> List[tuple]:
    """The reference put in the program's place, its products rounded as
    ``kinds`` ("encoder", "mel", "search", "fusion"): (path, embedding,
    payload) as the program's answers are judged."""
    cfg, dev = run.config, run.device
    enc_w = W.encoder_weights(cfg, run.seed, dev)
    fus_w = W.fusion_weights(cfg, run.seed, dev)
    names = [os.path.basename(p) for p in sv.db_paths]
    rows, labels, names = R.serving_rows(
        sv.anchors.to(dev), names, sv.db_labels, cfg["index_rows"], run.seed)
    row_ids = torch.as_tensor([file_id(nm) for nm in names],
                              dtype=torch.int64, device=dev)
    with torch.no_grad():
        tpp = reference_embeddings(cfg, enc_w, paths, dev, kinds=kinds)
        exclude = torch.as_tensor([file_id(p) for p in paths], device=dev)
        mask = RS.mask_rows(row_ids, rows.shape[0], exclude, "self")
        k = cfg["pipeline"]["top_k"]
        d, idx = RS.scan(tpp, rows, mask, k, kinds.get("search", "exact"))
        logits = RF.forward(fus_w, rows[idx], tpp,
                            n_hidden=len(cfg["pipeline"]
                                         ["detection_hidden_dims"]),
                            kind=kinds.get("fusion", "exact"))
    if fault == "altered":
        logits[0] += 1.0
    out = []
    for i, p in enumerate(paths):
        ids = idx[i].tolist()
        out.append((p, tpp[i], {
            "retrieved_files": [names[j] for j in ids],
            "retrieved": [{"distance": float(x)} for x in d[i].tolist()],
            "retrieved_labels": labels[idx[i]].tolist(),
            "logit": float(logits[i])}))
    return out
