#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``radad_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit, the precision flags, builds
   the native audio decoder (``radad_tpu_torch/native``, host g++; it must
   load) and the seven CUDA kernels from ``radad_tpu_torch/csrc`` (one
   ``nvcc`` each, in parallel): ``gather_rows``, ``exact_dot``,
   ``extract_candidates``, ``fused_mha``, ``flat_topk``, ``bias_gelu``
   and ``channel_ln_gelu``, with ptxas's registers and spills of each
   template instance;
2. holds each kernel against its plain PyTorch version on the card at the
   serving and training paths' shapes (``gather_rows`` at M = 5, 32, 40,
   256, 320, 640, 1,280 and 2,048 rows, each timed call reading its rows
   from device memory, not the L2; ``exact_dot`` at B = 1, 8, 64 (the
   serving batches), 128 and 256 (also at D = 3,584 below), each of its two
   forms (``split``, a block a candidate row, which the wrapper takes at
   B <= 64; ``per_query``) on f32, bf16 and int8 rows, two calls bitwise
   equal, and timed beside gather + ``bmm``, the form the wrapper picks
   printed, at B = 8 as the median and spread of 21 profiler samples;
   ``exact_dot`` on bf16 rows (the bf16-storage index) at every B and on
   SQ8's int8 codes at R = 40 candidates, B = 1 .. 256, each beside
   gather + cast + ``bmm``; ``extract_candidates`` at B = 1, 8, 64,
   128 and 256 queries, at T = 24, m = 8 and at SQ8's T = 8, m = 5;
   ``flat_topk`` at B = 64 and 8 also against the
   exact scores of its bf16 operands within the bound of its tensor-core
   summation order, with a control that an unrounded scan fails, and its
   f32 body (``fast_scan=False``) on the same inputs against
   ``flat_topk_plain(fast_scan=False)`` within the bound of its own
   summation order, timed beside f32 ``mm`` + |x|^2 + mask + ``topk``;
   ``fused_mha``'s two 3xTF32 bodies at T = 99, 600 and 1,500, and at head
   width 80 (the bias-free one also at whisper-large-v3's [2, 1500, 1280],
   20 heads, and at a rank of the mesh's TP encoder, [16, 99, 384], 6
   heads, beside SDPA f32), and its two bf16 bodies at the same shapes against their
   plain version within ``BF16_TOL`` * (1 + |plain|), timed beside SDPA on
   the same bf16 inputs and beside the streamed form (one pass over
   64-key tiles; wgmma at head width 64) that the wrapper takes above
   T = 128, and, where the resident form runs its ``wgmma`` kernel (head
   width 64 without bias), beside its ``mma.sync`` kernel on the same
   inputs; the tensor-core instructions (HMMA, HGMMA) of both kernels
   counted with ``cuobjdump``, per bf16 form, both resident kernels
   (``mma.sync`` at HD 64 and 80, ``wgmma`` at every N) and the streamed
   form's HD 64 ones required to build without a spill, ptxas's registers
   and spills of the streamed HD 64 and 128 instances printed) and takes
   the
   device time
   (``torch.profiler``) of kernel, plain version, and one PyTorch library
   call computing the same function (``library_ms``, used nowhere in the
   port); at whisper-base's shapes too: ``fused_mha``'s bias-free f32 body
   and its streamed bf16 form at [16, 1500, 512] and [128, 1500, 512]
   (8 heads of 64) beside SDPA (flash in bf16), with TFLOP/s and the
   ratios to SDPA and to the bound; the bf16 resident form at the trimmed
   shapes [16 | 128, 100, 512]; ``gather_rows`` and ``exact_dot`` on a
   [25,600, 3,584] table; ``bias_gelu`` (the bf16 bias add and tanh GELU)
   at whisper-base's FFN hidden state [128, 1500, 2048] and conv outputs
   [128, 512, 3000] and [128, 512, 1500] and at wav2vec2-base's bias-free
   first conv [128, 512, 9599], FFN [128, 149, 3072] and positional conv
   [128, 768, 150], equal bit for bit to the op-by-op chain (its plain
   version), timed beside it and the library's ``x + b`` then
   ``F.gelu(approximate="tanh")``; ``channel_ln_gelu`` (the layer-normed
   front end's bias add, LayerNorm over the channels and GELU) at
   wavlm-large's seven conv outputs [128, 512, 6399 .. 99] and at
   [128, 16, 3199], channels-last, every element within one bf16
   step of the chain's LayerNorm output or near 0 within the f32
   reordering's band of it (``compare_with_chain``), timed
   beside the chain and the library's add + ``F.layer_norm`` + ``F.gelu``;
   a WavLM-Large front end at published widths on 128 windows of 2 s
   timed against the chain's (row-major convs, the chain op by op);
3. wav2vec2 serving phase: a ``DetectionPipeline`` with a seeded random
   wav2vec2-base encoder (12 layers, 768 wide, f32) builds its DB from
   synthetic clips, the index is padded with seeded rows to 25,600 x 5,376
   (In-the-Wild scale), then ``predict`` on 1 clip and ``predict_batch``
   on 8 and 64 clips through the certified search; neighbors must agree
   with an f64 full scan up to ties within the f32 score's rounding, a
   bound computed from the inputs alone (``_hold_to_f64``), and
   ``gather_rows``, ``exact_dot`` (its split form alone, as on every
   serving path; the per-query form alone on the train paths) and
   ``extract_candidates`` must have launched; the searches and the
   certificate's fallbacks are counted per path, and the certified
   attempt is timed beside the full f32 scan. One
   more ``predict_batch(8)`` with ``RADAD_FUSED_ATTENTION=1`` must launch
   ``fused_mha``'s bias-free body, move the embeddings by less than 1e-4
   relative, hold its neighbors to the f64 scan, return distances within
   what the embedding change and f32 rounding explain at every rank, and
   give on every row a logit within 1e-4 of the fusion model's on the
   default embedding with the same neighbors (``_compare_fused``);
4. starts the port's HTTP server on localhost and posts 3 WAV uploads to
   ``/api/predict``; then the SQ8 phase (``sq8_phase``): the wav2vec2
   phase's 25,600 x 5,376 table added in one call to an SQ8
   ``DetectionPipeline`` at the shipped defaults, three ways (plain,
   residual with nlist 1,024, int4-refined; build, save and load timed,
   device bytes printed); each serves phase 3's calls (paths "sq8",
   "sq8_residual", "sq8_refine": ``exact_dot`` on int8 rows in its split
   form alone, ``extract_candidates`` at T = 8, m = 5 alone), trains one
   epoch and evaluates (B = 128 / 256; paths "<variant>_train": the
   per_query form alone) with step timings; every search is held to
   ``retrieve_on_device_sq8`` on the CPU with the plain kernels, ids up to
   ties within the f32 rounding of the dequantized rows and distances
   within 1e-5 relative, and recall@5 against the f32 certified neighbors
   and the stage times beside the f32 path's are printed; then the IVF
   phase (``ivf_phase``): the same table in one add to an IVF pipeline at
   the shipped defaults (nlist 4,096, nprobe 32; k-means, the assignment
   and the inverted lists timed apart, save -> load without k-means,
   device bytes), serving ``_counted_run``'s calls (path "ivf": each call
   kind's route must be the one the JAX package's gate, 2 B budget chunk
   < n, picks from the index's own state, at least one the gather route;
   gather results held to the same search on the CPU, ids up to ties
   within f32 rounding and probes flipped only within the rounding of the
   centroid distances (``_ivf_hold``); unprobed results held to the f64
   scan; ``exact_dot``, ``extract_candidates`` and ``gather_rows`` launched
   on the unprobed calls, never ``flat_topk``; recall@5 against the f32
   certified neighbors), ``FlatIndex.search`` at B = 64 with
   ``gather=False`` at nprobe 8, 32 and 128 (path "ivf_masked", held to an
   f64 scan of the probed rows; recall@5, call and device ms), both
   gather searches forced at B = 1 and 8 (held to the CPU), a
   ``use_pallas`` index (no ``flat_topk``), and one epoch + evaluate
   (path "ivf_train": the unprobed search's kernels, ``exact_dot`` in its
   per-query form alone); after the wav2vec2 pipeline is freed, IVF at
   capacity scale (``ivf_capacity_phase``), three times: 1,048,576 seeded
   f32 rows near a rank-64 subspace, then of 2,048 skewed isotropic
   components, then the first kind made in bf16 for
   ``FlatIndex(use_float16=True, single_buffer=True)`` (the JAX package's
   capacity regime), each made on the card and added in one call with
   ``donate=True``, which must adopt them without a copy (k-means on the
   first 50,000; peak device memory printed), the gather and masked routes
   at B = 1, 8 and 64 (paths "ivf_capacity", "ivf_capacity_skewed",
   "ivf_capacity_bf16": ``exact_dot`` on its bf16 rows), call and device ms
   beside their byte bounds, the gather route's neighbors held to the
   masked route's;
5. WavLM serving phase: a seeded random wavlm-base pipeline with
   ``use_pallas=True`` and ``RADAD_FUSED_ATTENTION=1`` on the same size of
   DB; the same calls must launch ``fused_mha``'s bias body, ``flat_topk``
   and ``gather_rows``; the kernel's candidates must lie within its f32
   rounding bound of the exact scores of the same bf16 operands
   (``radad_tpu_torch/ops/topk_check.py``), the final neighbors of every
   row must equal those of the same search run through ``flat_topk_plain``
   up to near-ties, and recall@5 against the f64 full scan is printed (the
   ``use_pallas`` route is not certified, so recall is not a condition);
6. hubert-xlarge phase (``fused_forward_phase``): a seeded random
   ``hubert-xlarge-ls960-ft`` encoder
   (48 layers, 1,280 wide, 16 heads of 80) embeds 8 two-second windows with
   ``RADAD_FUSED_ATTENTION=1``; ``fused_mha`` must launch once a layer and
   the features stay within 1e-4 relative of the same forward without it;
7. train phase: the trainer at the shipped defaults (wav2vec2-base, the
   BatchNorm head with dropout 0.1, batch 128, eval batch 256) on 500
   train and 300 val synthetic clips, the DB padded to 25,600 rows:
   ``train`` for 3 epochs and ``evaluate`` must launch ``gather_rows``,
   ``exact_dot`` and ``extract_candidates`` (path "train"); a train batch's
   (B = 128, batch exclusion) and an eval batch's (B = 256) retrieval must
   agree with the f64 scan up to near-ties; the card's update (dropout 0)
   must agree with the same update on the CPU; the saved checkpoint must
   load into a fresh pipeline with equal optimizer state and step and
   train one more epoch; the step's median retrieve / forward+backward /
   update ms, steps/s and the device busy share of a profiled step are
   printed; then the introspect phase (``introspect_phase``) on the
   trained pipeline (its BatchNorm head's running statistics, D = 5,376,
   K = 5 neighbors from its index, B = 64 and 256): ``activations`` with
   exactly the JAX package's 19 keys and the model's logits,
   ``attention_weights`` summing to 1, ``feature_importance`` against an
   f64 central difference, ``fuse_batch_norm``'s logits,
   ``predict_batch_proba`` against ``predict_proba``; one
   ``predict_batch(8)`` inside ``utils.profiling.trace`` whose file must
   name its ``annotate`` spans and the certified search's three kernels;
   ``profile_fn``, ``memory_stats``; ``checked`` in one host read, a NaN
   raising, ``nan_debug`` (path "introspect");
8. mixed precision (``use_mixed_precision=True``: bf16 encoders and fusion
   model, f32 parameters and clip embeddings): the wav2vec2 serving phase
   again in bf16 on its own index (neighbors against the f64 scan of its
   own embeddings; one ``predict_batch(8)`` with ``RADAD_FUSED_ATTENTION=1``
   must launch ``fused_mha``'s bias-free bf16 body, resident form only),
   printing the stage
   times beside the f32 phase's, each clip embedding's deviation from the
   f32 pipeline's and recall@5 of the bf16 neighbors against the f32 ones;
   the WavLM phase in bf16 (``fused_mha``'s bf16 bias body in its resident
   form only, ``flat_topk``, ``gather_rows``); the trainer in bf16 (path
   "train_bf16", the resident form only: the card's
   first update against the CPU's bf16 update, 1 epoch + ``evaluate``,
   save -> load, step timings); then the layer-normed front end on the
   serving path (``wavlm_large_bf16_phase``, path "wavlm_large_bf16"): a
   seeded random WavLM-Large pipeline at its published widths in bf16 with
   ``RADAD_FUSED_ATTENTION=1`` (wavlm-large-bulk's settings) on the same
   size of DB, 3 ``predict_batch`` calls of 64 clips whose every encoder
   forward must launch ``channel_ln_gelu`` 7 times and ``bias_gelu`` 25
   (the positional conv and 24 FFNs) and run no bf16 chain op by op, the
   neighbors held to the f64 scan;
9. Whisper serving (``whisper_phase``): a seeded random whisper-base
   pipeline (6 layers, 512 wide, 8 heads of 64; f32) on a 25,600 x 3,584
   index, every 2 s window padded to 30 s (T = 1,500) as the reference
   does: the serving calls of phase 3 with the certified search, held to
   the f64 scan, stage times and peak device memory; then predict_batch(8)
   and (64) with ``RADAD_FUSED_ATTENTION=1`` must launch ``fused_mha``'s
   bias-free f32 body 6 times a call and pass ``_compare_fused``; then the
   same serving calls with
   ``whisper_pad_seconds=None`` (``--whisper_fast``, T = 100) on its own
   index;
10. Whisper in mixed precision (``whisper_bf16_phase``) with
   ``RADAD_FUSED_ATTENTION=1``, each pad mode on its own index: the same
   calls and checks, ``fused_mha``'s bias-free bf16 body in the streamed
   form only at T = 1,500 and the resident form only at T = 100; stage
   times, embedding deviation and recall@5 against the f32 pipeline of
   the same pad mode printed;
11. whisper-large-v3 (``fused_forward_phase``: 32 layers, 1,280 wide, 20
   heads of 64, 128 mel bins): one forward of 2 padded windows with
   ``RADAD_FUSED_ATTENTION=1`` against the default attention, within 1e-4
   relative, 32 bias-free launches;
12. the mesh (``mesh_phase``, right after the IVF phase, on phase 3's
   table saved to disk): worlds of ranks spawned on cuda:0, each with a
   60 s collective timeout and a join deadline after which its ranks are
   killed and the phase fails. World 1 (NCCL, mesh 1 x 1) and world 4
   (gloo with CUDA tensors, 2 x 2): ``predict_batch`` and one train step;
   world 2 (gloo with CUDA tensors): a probe that gloo takes every
   collective the mesh moves on CUDA tensors (a refused one fails the
   phase), on 1 x 2 ``predict_batch`` at B = 8 and 64, SQ8
   plain and residual (nlist 1,024), IVF (nlist 4,096, nprobe 32: B = 64
   on the masked route, B = 1 on the sharded gather route, each rank's
   gate printed), a refined SQ8 refused, and the tensor-parallel
   wav2vec2-base (6 of 12 heads a rank through ``fused_mha`` f32, its
   launches counted a rank, path "mesh_tp"); on 2 x 1 three train steps at
   B = 128 with the BatchNorm head and dropout 0, then one epoch +
   ``evaluate`` at dropout 0.1. Serving is held to the f64 scan of the
   mesh's embeddings and to the one-device fusion model (logits within
   1e-4); SQ8 and IVF to the plain single-process form of their sharded
   search on the card (ids equal, distances within 1e-5 relative) and to
   that form run on the CPU copies of the same arrays (ids equal but for
   neighbors tied within f32 rounding, ``_hold_to_cpu``); each train step
   to the single-device trainer started from the same state
   (``tests/test_torch_train.py``'s rule, Adam's moments included),
   parameters bit-equal on every rank; the TP embeddings within rtol
   2e-4, atol 1e-5 of the replicated encoder with the plain attention.
   Each world prints its backend, ranks, rows a rank, peak memory a rank,
   the collectives counted and its median call and step ms beside the
   card line. The ranks share one card: no figure
   is a scaling figure.

Each phase sets the launch counts to 0 just before its counted run and
reads them just after (``bias_gelu``'s on every path: launched iff the
encoder is bf16, and then no GELU op by op; 8 launches a forward on the
bf16 Whisper paths, 20 on wav2vec2's and WavLM's; ``channel_ln_gelu``'s
too, which only the layer-normed front end of "wavlm_large_bf16"
launches); each serving path prints the audio decoder that ran and fails
unless it was the native one. The last line is
``{"ok": true, "device": {...}}``; the line before it is the kernel
table: for ``exact_dot`` and ``extract_candidates`` also each path's
searches and fallbacks and the launches whose search was certified
(``launches_answering``), and their launches by row type and by shape; a
time that the profiler could not take is marked ``<key>_source:
"cuda_events"``.
Any failure exits non-zero and prints no result. It imports nothing of
JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
L2_BYTES = 50 * 2**20  # H100 SXM L2
F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core rate
SEED = 0
DB_CLIPS = 256  # synthetic clips embedded through build_vector_database
INDEX_ROWS = 25_600  # In-the-Wild scale (25,423 clips)
TRAIN_CLIPS, VAL_CLIPS = 500, 300  # 4 and 2 batches, the last ones partial
# whisper-base's attention on the serving path padded to 30 s: (rows, T) of
# predict_batch at B = 8 and 64 (two windows a clip)
WHISPER_ATTN = ((16, 1500), (128, 1500))
# the same trimmed to the clip (--whisper_fast, T = 100)
WHISPER_FAST_ATTN = ((16, 100), (128, 100))
# the bias add and tanh GELU at the bf16 encoders' shapes for
# predict_batch(64), 128 windows: whisper-base padded to 30 s and
# wav2vec2-base at 3 s (its bias-free group-normed first conv, its FFN, its
# positional conv before the trim): {record key: (shape, the bias's axis,
# or None for no bias)}
BIAS_GELU_SHAPES = {"ffn": ((128, 1500, 2048), -1),
                    "conv1": ((128, 512, 3000), 1),
                    "conv2": ((128, 512, 1500), 1),
                    "w2v2_conv0": ((128, 512, 9599), None),
                    "w2v2_ffn": ((128, 149, 3072), -1),
                    "w2v2_pos_conv": ((128, 768, 150), 1)}
# the layer-normed front end's conv outputs (wavlm-large-bulk: 128 windows
# of 2 s, 512 channels, conv 0 .. 6) and a ragged case of the tests'
# width: {record key: [B, C, T]}
CHANNEL_LN_GELU_SHAPES = {
    **{f"conv{i}": (128, 512, t) for i, t in enumerate(
        (6399, 3199, 1599, 799, 399, 199, 99))},
    "ragged": (128, 16, 3199)}
# fused_mha's bias-free f32 body at the other shapes a path launches it:
# {record key: ((rows, T, width, heads), the path)}
F32_NO_BIAS_PATHS = {
    "whisper_large_v3": ((2, 1500, 1280, 20), "whisper-large-v3, 2 windows "
                                              "padded to 30 s"),
    "tp_rank": ((16, 99, 384, 6), "a rank of the mesh's TP wav2vec2-base: 8 "
                                  "clips x 2 windows, 6 of 12 heads")}
# fused_mha's bf16 forms -> the kernel symbols of each (mangled-name
# prefixes): the mma.sync kernel (templated on the head width and the bias)
# and the wgmma kernel that takes head width 64 (the streamed form's is
# templated on the bias; the resident form's takes no bias and is
# templated on the keys of S)
BF16_FORMS = {"resident": ("mha_bf16_resident_kernel",
                           "mha_bf16_resident_wgmma_kernel"),
              "streamed": ("mha_bf16_streamed_kernel",
                           "mha_bf16_wgmma_kernel")}
# the C entry's form code of the resident form's mma.sync kernel at head
# width 64 without bias, where the wrapper's pick runs the wgmma kernel
RESIDENT_MMA = 2
# exact_dot's B (R = 32) on the serving paths (predict, predict_batch at 8
# and 64) and on the train and eval batches
EXACT_DOT_SERVING_B = (1, 8, 64)
EXACT_DOT_TRAIN_B = (128, 256)
# SQ8's re-score: T = 8 tiles x m = 5 rounds of the tile select at k = 5
SQ8_R = 40
# the SQ8 phase's index variants: (path label, config fields)
SQ8_VARIANTS = (("sq8", {}), ("sq8_residual", {"sq8_residual_nlist": 1024}),
                ("sq8_refine", {"sq8_refine_bits": 4}))
# IVF at the shipped defaults (radad_tpu/config.py: vector_db_nlist,
# vector_db_nprobe); the masked route's nprobe sweep; the capacity step's
# rows, of wav2vec2-base's TPP width
IVF_NLIST, IVF_NPROBE = 4096, 32
IVF_MASKED_NPROBES = (8, 32, 128)
IVF_CAPACITY_ROWS, IVF_CAPACITY_DIM = 1_048_576, 5376
# the capacity step's rows: (path, how they are made, storage). "latent":
# a seeded rank-64 Gaussian latent mapped to D, plus small noise: rows near
# a low-dimensional subspace, as embeddings lie, whose k-means cells come
# out near their mean size. "blobs": 2,048 components of isotropic unit
# noise with lognormal(0, 1) weights; in 5,376 dimensions k-means cannot
# split such a component, and the points of components without a centroid
# of their own all fall in one cell (the gather route's worst case).
# Storage "f32": f32 rows, the index's bf16 scan copy and residual beside
# them; "bf16": the JAX package's capacity regime
# (experiments/serve_load_test.py:108-115), rows made in bf16 for
# FlatIndex(use_float16=True, single_buffer=True), one bf16 buffer
IVF_CAPACITY_DATA = (("ivf_capacity", "latent", "f32"),
                     ("ivf_capacity_skewed", "blobs", "f32"),
                     ("ivf_capacity_bf16", "latent", "bf16"))


def _bf16_instance(form: str, hd: int, bias: bool) -> str:
    """The mangled-name part that names the fused_mha bf16 kernel instance
    that the wrapper's ``form`` runs at head width ``hd``."""
    mma, wgmma = BF16_FORMS[form]
    if hd == 64 and form == "streamed":
        return f"{wgmma}ILb{int(bias)}E"
    if hd == 64 and not bias:
        return f"{wgmma}ILi"  # every instance (keys of S: 64, 104, 128)
    return f"{mma}ILi{hd}ELb{int(bias)}E"


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, from CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class NoDeviceEvents(RuntimeError):
    """``device_ms`` found no device time of a call in 3 profiler
    sessions."""


def _span(event) -> bool:
    """Whether a profiler event is one of the port's spans (``radad.*``),
    which the profiler also lays on the device's timeline as a user
    annotation the length of the work under it: no device work of its
    own."""
    return event.key.startswith("radad.")


def device_ms(torch, fn, iters: int = 20, name: str = "") -> float:
    """Mean device milliseconds per call: the time of every kernel and
    copy ``fn`` runs on the card whose name holds ``name``, summed by
    ``torch.profiler`` over ``iters`` calls (host launch gaps excluded). A
    session that lost device events, seen as no device time (once in some
    hundreds of sessions in one process) or as a kernel counted other than
    a whole number of times a call (a 0.18 ms kernel once read 0.11 ms),
    is run again, up to 3 sessions in all. Where all 3 lost events (one
    kernel of 20 calls counted 19 times in 3 sessions in a row), each
    kernel's mean over the events kept, times its launches a call, is the
    time. Raises ``NoDeviceEvents`` where all 3 kept no device event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if getattr(getattr(e, "device_type", None), "name", "")
                == "CUDA" and name in e.key and not _span(e)]
        total_us = sum(e.device_time_total for e in seen)
        if total_us > 0 and all(e.count % iters == 0 for e in seen):
            return total_us / 1e3 / iters
    per_call = [round(e.count / iters) for e in seen]
    if seen and all(per_call) and total_us > 0:
        print(f"device_ms: the profiler lost events of *{name}* in 3 "
              f"sessions {[(e.key[:40], e.count) for e in seen]}; timed "
              f"from the mean of the events kept")
        return sum(e.device_time_total / e.count * k
                   for e, k in zip(seen, per_call)) / 1e3
    raise NoDeviceEvents(f"the profiler kept no device event of *{name}* in "
                         f"3 sessions: {[(e.key, e.count) for e in seen]}")


def timed_ms(torch, fn, iters: int = 20):
    """(ms, source): ``device_ms`` of ``fn`` ("profiler"), or, where the
    profiler kept no device event of it, the CUDA-event time of
    back-to-back calls, host launch gaps included ("cuda_events")."""
    try:
        return device_ms(torch, fn, iters), "profiler"
    except NoDeviceEvents as e:
        print(f"timed_ms: {e}; timed on CUDA events")
        return time_ms(torch, fn, iters), "cuda_events"


def _kernel_breakdown(torch, fn, iters: int = 10, top: int = 8) -> str:
    """The device ms a call of ``fn`` spends in each of its ``top`` most
    costly kernels and copies (``torch.profiler`` over ``iters`` calls),
    and in all of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if getattr(getattr(e, "device_type", None), "name", "") == "CUDA"
           and not _span(e)]
    dev.sort(key=lambda e: -e.device_time_total)
    total = sum(e.device_time_total for e in dev) / 1e3 / iters
    return f"{total:.4f} ms in {sum(e.count for e in dev) / iters:.0f} " \
        f"launches: " + "; ".join(
            f"{e.key[:48]} x{e.count / iters:.0f} "
            f"{e.device_time_total / 1e3 / iters:.4f}" for e in dev[:top])


def timings(torch, kernel, plain, library, iters: int = 20) -> dict:
    """Device ms per call of the kernel, its plain version and the library
    call (``device_ms``), plus the kernel wrapper's per-call time on the
    CUDA-event clock (``call_ms``: back-to-back calls, host launch overhead
    included). Where the profiler kept no device event of one of the three
    (flash SDPA at [16, 1500, 512] and ``index_select`` at M = 320 each
    once in a run, never in the next), that number is the CUDA-event time
    of back-to-back calls instead, host launch gaps included, and the
    record says so: ``<key>_source: "cuda_events"``; such a number is no
    device time to hold a kernel against."""
    rec = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        rec[key], source = timed_ms(torch, fn, iters)
        if source != "profiler":
            rec[f"{key}_source"] = source
    rec["call_ms"] = time_ms(torch, kernel, iters)
    return rec


class ColdRows:
    """Ids and an output ring for timed gathers of ``m`` rows of an
    ``[n, ...]`` table that read their rows from device memory, not from
    the L2: call i takes the next ``m`` ids of a random permutation of the
    rows, so a row comes back only after every other row was read, and
    ``keep`` holds each output in a ring of more than twice the L2, so that
    later calls write to fresh lines."""

    def __init__(self, torch, n: int, m: int, out_bytes: int, g):
        perm = torch.randperm(n, generator=g, device=g.device)
        self.ids32 = torch.cat([perm, perm[:m]]).to(torch.int32)
        self.ids64 = self.ids32.long()
        self.n, self.m, self.i = n, m, 0
        self.ring = [None] * max(2, -(-2 * L2_BYTES // out_bytes))

    def next(self, wide: bool = False):
        """The next call's ids, int32 (or int64 where ``wide``)."""
        start = (self.i * self.m) % self.n
        self.i += 1
        return (self.ids64 if wide else self.ids32)[start:start + self.m]

    def keep(self, out):
        self.ring[self.i % len(self.ring)] = out
        return out


def bound_ms(nbytes: float, flops: float = 0.0, rate: float = F32_FLOPS):
    """(least ms for the card to move ``nbytes`` and do ``flops``
    operations at ``rate`` FLOP/s, which of the two bounds it)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / rate) * 1e3, (
        "bytes" if nbytes / HBM_BYTES_PER_S >= flops / rate
        else "operations")


def header(torch):
    """Card, versions and precision flags; builds every kernel."""
    from radad_tpu_torch.ops import _native
    from radad_tpu_torch.utils.device import resolve_device

    card = _card_line()
    dev = resolve_device("cuda")  # also sets the precision flags
    print(card)  # nvidia-smi's name,power.limit line as it printed it
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    print("precision: matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} "
          "matmul.allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    from radad_tpu_torch import native

    t0 = time.perf_counter()
    decoder = native.load()  # raises if g++ or the build fails
    print(f"native audio decoder: {os.path.relpath(decoder.path)} built and "
          f"loaded in {time.perf_counter() - t0:.2f} s")
    secs = _native.build()
    print(f"kernel build: {secs:.2f} s for {list(_native.SOURCES)}")
    for name in _native.SOURCES:
        for fn, line in ptxas_lines(_native.build_reports.get(name, "")):
            print(f"  ptxas[{name}] {fn}: {line}")
    return card, dev


def ptxas_lines(report: str):
    """(entry function, line) for each register and spill line of a
    ``-Xptxas -v`` report, each named by the ``Compiling entry function`` /
    ``Function properties for`` line before it (the template instance)."""
    fn = "?"
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line.strip()
        elif "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif "registers" in line or "spill" in line:
            yield fn, line.strip()


def kernel_phase(torch, dev):
    """Each kernel against its plain version at the serving path's shapes.
    Returns {name: record} without the launch counts."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    n, d = 25_600, 5_376
    table = torch.randn((n, d), generator=g, device=dev)
    recs = {}

    # gather_rows: the neighbor fetch's M = 5 B rows at B = 1, 8, 64, 128
    # (the train batch), 256 (5, 40, 320, 640, 1,280) and the use_pallas
    # re-rank's M = 32 B at B = 1, 8, 64 (32, 256, 2,048), checked with
    # out-of-range ids that both versions clamp, timed on ids that read
    # every row from device memory
    by_m = {}
    for m in (5, 32, 40, 256, 320, 640, 1_280, 2_048):
        by_m[m] = rec = _gather_record(torch, table, m, g)
        print(f"gather_rows M={m}: device {rec['ms']:.4f} ms, index_select "
              f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms")
    recs["gather_rows"] = dict(
        route="cuda", source="radad_tpu_torch/csrc/gather_rows.cu",
        replaces="radad_tpu/ops/gather.py:96", max_abs_err=0.0,
        tolerance="bit-equal", **by_m[1_280], by_shape=_shape_table(by_m, "M"),
        shape=f"x [{n},{d}] f32, idx [1280] (by_shape: M = 5 .. 2048)")

    # exact_dot: B = 256 (eval batch) and 128 (train batch), 64, 8 and 1
    # (wav2vec2 serving) queries x R = 32 candidates, f32, bf16 and int8
    # rows, both forms. Tolerance: f32 summation order,
    # |err| <= 1e-5 * sum_d |q_d x_d|.
    r = 32
    tables = _row_types(torch, table, g)
    by_b, by_b_bf16, errs = {}, {}, {}
    for b in EXACT_DOT_TRAIN_B[::-1] + EXACT_DOT_SERVING_B[::-1]:
        q = torch.randn((b, d), generator=g, device=dev)
        cidx = torch.randint(0, n, (b, r), generator=g, device=dev,
                             dtype=torch.int32)
        errs[b] = _exact_dot_forms(torch, q, tables, cidx)
        by_b[b] = rec = _exact_dot_record(torch, q, table, cidx,
                                          samples=21 if b == 8 else 0)
        rec["max_abs_err"] = max(errs[b].values())
        _print_exact_dot(f"D={d} B={b}", rec, errs[b])
        # the same queries and ids on bf16 rows (the bf16-storage index),
        # beside gather + cast + bmm
        by_b_bf16[b] = rec = _exact_dot_record(torch, q, tables["bf16"],
                                               cidx)
        rec["max_abs_err"] = max(v for k, v in errs[b].items()
                                 if k.endswith(" bf16"))
        _print_exact_dot(f"bf16 rows D={d} B={b}", rec,
                         {k: v for k, v in errs[b].items()
                          if k.endswith(" bf16")})
    # exact_dot on SQ8's int8 codes: R = 40 candidates (T = 8 tiles x m =
    # 5), split at the serving B, per_query at the train and eval B
    by_b_int8 = {}
    for b in EXACT_DOT_TRAIN_B[::-1] + EXACT_DOT_SERVING_B[::-1]:
        q = torch.randn((b, d), generator=g, device=dev)
        cidx = torch.randint(0, n, (b, SQ8_R), generator=g, device=dev,
                             dtype=torch.int32)
        err = _exact_dot_err(torch, q, tables["int8"], cidx)
        by_b_int8[b] = rec = _exact_dot_record(torch, q, tables["int8"], cidx)
        rec["max_abs_err"] = err
        _print_exact_dot(f"int8 D={d} R={SQ8_R} B={b}", rec,
                         {f"{rec['form']} int8": err})
    del tables
    recs["exact_dot"] = dict(
        route="cuda", source="radad_tpu_torch/csrc/exact_dot.cu",
        replaces="radad_tpu/ops/rerank.py:131",
        tolerance="1e-5 * sum|q*x| (f32 summation order), each form, f32, "
                  "bf16 and int8 rows; two calls bitwise equal",
        **by_b[256], by_shape=_shape_table(by_b, "B"),
        shape=f"q [256,{d}] f32, x [{n},{d}] f32, idx [256,{r}] (by_shape: "
              f"B = 1 .. 256; ms_by_form: each form on the same inputs)")
    recs["exact_dot"]["max_abs_err"] = max(
        rec["max_abs_err"] for rec in (*by_b.values(), *by_b_int8.values()))
    recs["exact_dot"]["bf16_rows"] = dict(
        shape=f"q [B,{d}] f32, x [{n},{d}] bf16, idx [B,{r}] (the bf16-"
              f"storage index; library: gather + cast + bmm)",
        **_shape_table(by_b_bf16, "B"))
    recs["exact_dot"]["sq8_int8"] = dict(
        shape=f"q [B,{d}] f32, x [{n},{d}] int8, idx [B,{SQ8_R}] (SQ8's "
              f"re-score; library: gather + cast + bmm)",
        **_shape_table(by_b_int8, "B"))

    # extract_candidates: B = 1, 8, 64, 128, 256 queries at the certified
    # search's T = 24 tiles of 128 lanes, m = 8 rounds, and at the SQ8
    # route's T = 8, m = 5, with exact ties, all-(-inf) tiles and a -0 at a
    # lower lane than a +0 (the lower lane goes first)
    nt = n // 128
    by_b = {bb: _extract_record(torch, g, bb, 24, 8, nt)
            for bb in (1, 8, 64, 128, 256)}
    sq8_select = {bb: _extract_record(torch, g, bb, 8, 5, nt)
                  for bb in (1, 8, 64, 128, 256)}
    t, mm = 24, 8
    recs["extract_candidates"] = dict(
        route="cuda", source="radad_tpu_torch/csrc/extract_candidates.cu",
        replaces="radad_tpu/ops/topk.py:338", max_abs_err=0.0,
        tolerance="equal (values as floats: a zero maximum is +0), rows and "
                  "leftover exact",
        **by_b[256], by_shape=_shape_table(by_b, "B"),
        shape=f"cand [256,{t},128] f32, m={mm} (by_shape: B = 1 .. 256)",
        sq8=dict(shape="cand [B,8,128] f32, m=5, nt=200 (SQ8's select)",
                 **_shape_table(sq8_select, "B")))
    recs["fused_mha"] = _fused_mha_record(torch, g)
    recs["fused_mha_bf16"] = _fused_mha_bf16_record(torch, g)
    recs["flat_topk"] = _flat_topk_record(torch, dev, g, table)
    recs["bias_gelu"] = _bias_gelu_record(torch, g)
    recs["channel_ln_gelu"] = _channel_ln_gelu_record(torch, dev, g)
    for name, by_shape in _whisper_kernel_records(torch, dev, g).items():
        recs[name]["whisper"] = by_shape
    for name in ("gather_rows", "exact_dot", "extract_candidates"):
        recs[name]["bound_rate"] = "f32 67 TFLOP/s"
    for name, rec in recs.items():
        print(f"kernel {name}: {rec['shape']}: device {rec['ms']:.4f} ms "
              f"(per call on the event clock {rec['call_ms']:.4f} ms), "
              f"plain {rec['plain_ms']:.4f} ms, library "
              f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), "
              f"max_abs_err {rec['max_abs_err']:.3e} ({rec['tolerance']})")
    del table
    torch.cuda.empty_cache()
    return recs


def _extract_record(torch, g, bb: int, t: int, mm: int, nt: int) -> dict:
    """``extract_candidates`` on ``[bb, t, 128]`` seeded scores with exact
    ties, all-(-inf) tiles, a tile of one value and a -0 at a lower lane
    than a +0: equal to its plain version (the -0 goes first), timed beside
    it and ``torch.topk``; bound: the inputs read and the outputs written
    once, against a max, a compare and a select per round and lane."""
    from radad_tpu_torch.ops.topk import (extract_candidates,
                                          extract_candidates_plain)

    dev = g.device
    cand = torch.randn((bb, t, 128), generator=g, device=dev)
    cand[0, 0, :] = float("-inf")
    cand[5 % bb, 3 % t, :] = float("-inf")
    cand[1 % bb, t - 1, 7] = cand[1 % bb, t - 1, 99]
    cand[2 % bb, 4 % t, :] = 0.5  # a whole tile tied
    cand[3 % bb, 2, 10:20] = float("-inf")
    cand[0, 1, :] = -1.0 - torch.rand(128, generator=g, device=dev)
    cand[0, 1, 9], cand[0, 1, 40] = -0.0, 0.0
    tsel = torch.randint(0, nt, (bb, t), generator=g, device=dev,
                         dtype=torch.int32)
    got = extract_candidates(cand, tsel, mm, nt)
    want = extract_candidates_plain(cand, tsel, mm, nt)
    torch.cuda.synchronize()
    for gv, wv, what in zip(got, want, ("vals", "rows", "leftover")):
        if not torch.equal(gv, wv):
            raise AssertionError(f"extract_candidates B={bb} T={t} m={mm} "
                                 f"{what} differs from its plain version")
    if int(got[1][0, 1]) != 9 * nt + int(tsel[0, 1]):
        raise AssertionError("extract_candidates: the -0 at the lower lane "
                             "did not go first")
    rec = timings(torch, lambda: extract_candidates(cand, tsel, mm, nt),
                  lambda: extract_candidates_plain(cand, tsel, mm, nt),
                  lambda: torch.topk(cand, mm, dim=-1))
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        bb * t * 128 * 4 + bb * t * 4 + bb * mm * t * 8 + bb * t * 4,
        3.0 * bb * t * 128 * mm)
    print(f"extract_candidates B={bb} T={t} m={mm}: device {rec['ms']:.4f} "
          f"ms, topk {rec['library_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms")
    return rec


def _gather_record(torch, table, m: int, g) -> dict:
    """``gather_rows`` of ``m`` rows of ``table [n, d]``: bit-equal to its
    plain version on ids with out-of-range entries that both clamp; timed
    beside the plain version and ``index_select`` on ids that read every
    row from device memory (``ColdRows``); bound: the m distinct source
    rows read once, every output row written once, the ids read once."""
    from radad_tpu_torch.ops.gather import gather_rows, gather_rows_plain

    n, d = table.shape
    idx = torch.randint(0, n, (m,), generator=g, device=table.device,
                        dtype=torch.int32)
    idx[:3] = torch.tensor([-1, n, n + 7], device=table.device,
                           dtype=torch.int32)
    got = gather_rows(table, idx)
    want = gather_rows_plain(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"gather_rows D={d} M={m} differs from its "
                             f"plain version")
    cold = ColdRows(torch, n, m, m * d * 4, g)
    rec = timings(
        torch, lambda: cold.keep(gather_rows(table, cold.next())),
        lambda: cold.keep(gather_rows_plain(table, cold.next())),
        lambda: cold.keep(torch.index_select(table, 0, cold.next(wide=True))))
    rec["bound_ms"], rec["bound_by"] = bound_ms(2 * m * d * 4 + m * 4)
    return rec


def _exact_dot_err(torch, q, x, cidx) -> float:
    """Max |exact_dot - exact_dot_plain| of ``q`` against rows ``cidx`` of
    ``x``; raises outside the f32 summation-order tolerance
    1e-5 * sum_d |q_d x_d|."""
    from radad_tpu_torch.ops.rerank import exact_dot, exact_dot_plain

    got = exact_dot(q, x, cidx)
    want = exact_dot_plain(q, x, cidx)
    scale = (x[cidx.long()].float().abs() * q.abs()[:, None, :]).sum(-1)
    torch.cuda.synchronize()
    err = (got - want).abs()
    if not bool((err <= 1e-5 * scale).all()):
        raise AssertionError(f"exact_dot[{x.dtype}] B={q.shape[0]} "
                             f"D={q.shape[1]} outside tolerance: max err "
                             f"{float(err.max())}")
    return float(err.max())


def _row_types(torch, table, g) -> dict:
    """{"f32", "bf16", "int8": a [n, d] table of that row type} (int8:
    seeded codes in [-127, 127])."""
    return {"f32": table, "bf16": table.to(torch.bfloat16),
            "int8": torch.randint(-127, 128, table.shape, generator=g,
                                  device=table.device, dtype=torch.int8)}


def _exact_dot_form_call(torch, q, x, cidx, form: str):
    """A call of exact_dot's C entry with the form given (the wrapper picks
    the form by shape; this checks and times the other one beside it)."""
    from radad_tpu_torch.ops import _native
    from radad_tpu_torch.ops.rerank import _X_KIND, FORMS

    out = torch.empty(cidx.shape, dtype=torch.float32, device=q.device)
    fn = _native.library("exact_dot").radad_exact_dot

    def call():
        _native.check_launch("exact_dot", fn(
            q.data_ptr(), x.data_ptr(), cidx.data_ptr(), out.data_ptr(),
            q.shape[0], x.shape[0], q.shape[1], cidx.shape[1],
            _X_KIND[x.dtype], FORMS.index(form), _native.stream_of(q)))
        return out
    return call


def _exact_dot_forms(torch, q, tables, cidx) -> dict:
    """Each of exact_dot's forms, on each row type of ``tables``, against
    ``exact_dot_plain`` within 1e-5 * sum_d |q_d x_d|, two calls bitwise
    equal (the summation order is fixed: no atomics); the wrapper's own
    pick too (``_exact_dot_err``). → {"<form> <row type>": max |err|}."""
    from radad_tpu_torch.ops.rerank import FORMS, exact_dot_plain

    errs = {}
    for kind, x in tables.items():
        _exact_dot_err(torch, q, x, cidx)
        want = exact_dot_plain(q, x, cidx)
        scale = (x[cidx.long()].float().abs() * q.abs()[:, None, :]).sum(-1)
        for form in FORMS:
            call = _exact_dot_form_call(torch, q, x, cidx, form)
            first = call().clone()
            again = call().clone()
            torch.cuda.synchronize()
            err = (first - want).abs()
            if not bool((err <= 1e-5 * scale).all()):
                raise AssertionError(
                    f"exact_dot {form} [{kind}] B={q.shape[0]} "
                    f"D={q.shape[1]} outside tolerance: max err "
                    f"{float(err.max())}")
            if not torch.equal(first, again):
                raise AssertionError(f"exact_dot {form} [{kind}] "
                                     f"B={q.shape[0]}: two calls differ")
            errs[f"{form} {kind}"] = float(err.max())
    return errs


def device_ms_samples(torch, fn, n: int = 21, iters: int = 10) -> dict:
    """``n`` samples of ``device_ms`` (each a profiler session of ``iters``
    calls): their count, median and spread (min, max, quartiles). A
    session whose device events the profiler lost is no sample (``lost``
    counts them); after ``n`` such sessions the samples are CUDA-event
    times instead (``source``: "cuda_events", host launch gaps
    included)."""
    import numpy as np

    xs, lost, source = [], 0, "profiler"
    while len(xs) < n and lost < n:
        try:
            xs.append(device_ms(torch, fn, iters))
        except NoDeviceEvents:
            lost += 1
    if len(xs) < n:
        xs, source = [time_ms(torch, fn, iters) for _ in range(n)], \
            "cuda_events"
    xs.sort()
    q1, med, q3 = (float(v) for v in np.percentile(xs, [25, 50, 75]))
    return dict(n=n, lost=lost, source=source, median=med, min=xs[0],
                max=xs[-1], q1=q1, q3=q3)


def _exact_dot_record(torch, q, table, cidx, samples: int = 0) -> dict:
    """``exact_dot`` of ``q [b, d]`` against rows ``cidx [b, r]`` of
    ``table``, timed beside its plain version and gather + ``bmm``, and
    each form on the same inputs (``ms_by_form``; ``form``: the wrapper's
    pick); bound: each distinct candidate row read once (at the table's
    element size), q and the ids read, the output written, against 2 b r d
    operations at the f32 rate. The library call casts the gathered rows to
    f32 before the ``bmm`` (int8 rows; a no-op on f32).
    ``samples``: also that many profiler samples of each form and of
    gather + ``bmm`` (``device_ms_samples``), whose medians are the record's
    times."""
    from radad_tpu_torch.ops.rerank import (FORMS, exact_dot, exact_dot_form,
                                            exact_dot_plain)

    (b, d), r = q.shape, cidx.shape[1]

    def library():  # gather + cast (a no-op on f32 rows) + bmm
        return torch.bmm(table[cidx.long()].float(), q[:, :, None])

    rec = timings(torch, lambda: exact_dot(q, table, cidx),
                  lambda: exact_dot_plain(q, table, cidx), library)
    rec["form"] = exact_dot_form(b, r, d)
    calls = {form: _exact_dot_form_call(torch, q, table, cidx, form)
             for form in FORMS}
    by_form = {form: timed_ms(torch, call) for form, call in calls.items()}
    rec["ms_by_form"] = {form: ms for form, (ms, _) in by_form.items()}
    if any(src != "profiler" for _, src in by_form.values()):
        rec["ms_by_form_source"] = {f: src for f, (_, src) in by_form.items()}
    if samples:
        rec["samples"] = {name: device_ms_samples(torch, fn, samples)
                          for name, fn in (*calls.items(),
                                           ("library", library))}
        rec["ms_by_form"] = {form: rec["samples"][form]["median"]
                             for form in FORMS}
        rec.pop("ms_by_form_source", None)
        rec["ms"] = rec["ms_by_form"][rec["form"]]
        rec["library_ms"] = rec["samples"]["library"]["median"]
    rows_read = int(torch.unique(cidx).numel())
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        rows_read * d * table.element_size() + b * d * 4 + 2 * b * r * 4,
        2.0 * b * r * d)
    return rec


def _print_exact_dot(label: str, rec: dict, errs: dict) -> None:
    forms = ", ".join(f"{f} {ms:.4f}" for f, ms in rec["ms_by_form"].items())
    print(f"exact_dot {label}: the wrapper picks {rec['form']}: device "
          f"{rec['ms']:.4f} ms (by form: {forms}), gather + bmm "
          f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms; max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (tolerance 1e-5 * sum|q*x|; two calls bitwise equal)")
    for name, smp in rec.get("samples", {}).items():
        print(f"  {label} {name}: median of {smp['n']} samples "
              f"({smp['source']}; {smp['lost']} profiler sessions lost) "
              f"{smp['median']:.5f} ms, quartiles {smp['q1']:.5f} .. "
              f"{smp['q3']:.5f}, min {smp['min']:.5f}, max {smp['max']:.5f}")


def _pick(rec: dict, keys) -> dict:
    """``keys`` of ``rec``, each with its ``<key>_source`` where
    ``timings`` left one."""
    return {k: rec[k] for key in keys
            for k in (key, f"{key}_source") if k in rec}


def _shape_table(by_shape: dict, key: str) -> dict:
    """{"<key>=<n>": the timings and bound at that shape}."""
    keep = ("ms", "plain_ms", "library_ms", "call_ms", "bound_ms",
            "bound_by", "form", "ms_by_form", "max_abs_err", "streamed_ms",
            "resident_mma_ms", "max_rel_err")
    return {f"{key}={n}": _pick(r, keep) for n, r in by_shape.items()}


def _fused_mha_at(torch, g, shape, dtype, bias: bool, timed: bool = True,
                  iters: int = 20, streamed: bool = False) -> dict:
    """``fused_mha`` at ``shape`` (b, t, d, heads) in ``dtype``, with the
    position bias or without, on seeded inputs (q scaled by hd^-0.5; gate
    in [1, 3), pos_bias ~ N(0, 1)). Held to its plain version: f32 to
    ``mha_reference`` within 1e-5 (1 + |plain|) (3xTF32 products, f32
    summation order, online softmax; 1xTF32 is 20-100x outside it); bf16
    to ``fused_mha_plain`` within BF16_TOL (1 + |plain|) in f32 (weights
    rounded to bf16 as the Pallas body; bf16 output), with the largest
    error in bf16 steps. ``timed``: device ms beside the plain version and
    SDPA on the same inputs (the bias materialized as a [B, H, T, T] mask,
    untimed; bf16 without bias: flash), and the bound: q, k, v, out (and
    gate, pos_bias) read or written once at 3.35 TB/s against one Q K^T
    and one P V, three times at the TF32 rate (3xTF32) or once at the
    bf16 rate. ``streamed``: the bf16 streamed form's ms on the same
    inputs too, and where the wrapper runs the resident form's wgmma kernel
    (T <= 128, head width 64, no bias) the mma.sync resident kernel's
    (``resident_mma_ms``). → record."""
    import torch.nn.functional as F

    from radad_tpu_torch.ops.attention import (BF16_TOL, bf16_form,
                                               fused_mha, fused_mha_plain,
                                               mha_reference)

    b, t, d, h = shape
    hd, dev, f32 = d // h, g.device, dtype == torch.float32
    q, k, v = (torch.randn((b, t, d), generator=g, device=dev)
               for _ in range(3))
    q *= hd ** -0.5
    extra = {}
    if bias:
        extra = dict(gate=1.0 + 2.0 * torch.rand((b, t, h), generator=g,
                                                 device=dev),
                     pos_bias=torch.randn((h, t, t), generator=g, device=dev))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    extra = {n: x.to(dtype) for n, x in extra.items()}
    plain, tol = ((mha_reference, 1e-5) if f32
                  else (fused_mha_plain, BF16_TOL))
    name = (f"fused_mha {'f32' if f32 else 'bf16'} "
            f"{'bias' if bias else 'no bias'} [{b},{t},{d}] {h} heads"
            + ("" if f32 else f" ({bf16_form(t, hd)} form)"))
    got = fused_mha(q, k, v, h, **extra)
    want = plain(q, k, v, h, **extra)
    torch.cuda.synchronize()
    if got.dtype != dtype:
        raise AssertionError(f"{name} returned {got.dtype}")
    err = (got.float() - want.float()).abs()
    rec = dict(max_abs_err=float(err.max()),
               max_rel_err=float((err / (1 + want.float().abs())).max()))
    if not f32:
        rec["max_bf16_steps"] = _bf16_steps(err, want.float())
    del got, want, err
    text = (f"max |err| {rec['max_abs_err']:.3e} ({rec['max_rel_err']:.3e} "
            f"of 1 + |plain|, tolerance {tol})")
    if not rec["max_rel_err"] <= tol:  # a NaN fails too
        raise AssertionError(f"{name} outside its tolerance: {text}")
    if not timed:
        print(f"{name}: {text}")
        return rec
    qh, kh, vh = (x.view(b, t, h, hd).transpose(1, 2) for x in (q, k, v))
    mask = None
    if bias:
        mask = (extra["gate"].float().transpose(1, 2)[..., None]
                * extra["pos_bias"].float()[None]).to(dtype)
    rec.update(timings(
        torch, lambda: fused_mha(q, k, v, h, **extra),
        lambda: plain(q, k, v, h, **extra),
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                               scale=1.0), iters))
    others = ()
    if streamed:
        others = ("streamed",) + (
            ("resident_mma",) if hd == 64 and not bias
            and bf16_form(t, hd) == "resident" else ())
    for form in others:
        ms, src = timed_ms(torch, _bf16_form_call((q, k, v), h, extra,
                                                   form), iters)
        rec[f"{form}_ms"] = ms
        if src != "profiler":
            rec[f"{form}_ms_source"] = src
    size = 4 if f32 else 2
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        4 * b * t * d * size + ((b * t * h + h * t * t) * size if bias else 0),
        (3.0 if f32 else 1.0) * 4.0 * b * h * t * t * hd,
        rate=TF32_FLOPS if f32 else BF16_FLOPS)
    print(f"{name}: device {rec['ms']:.4f} ms"
          + (f" (streamed form {rec['streamed_ms']:.4f})" if streamed else "")
          + (f" (resident form's mma.sync kernel "
             f"{rec['resident_mma_ms']:.4f})" if "resident_mma_ms" in rec
             else "")
          + f", SDPA {rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f}"
          f" ms ({rec['bound_by']}), plain {rec['plain_ms']:.4f} ms; {text}")
    return rec


def _hmma(counts: dict, symbol: str, hds=(64, 80)) -> dict:
    """{"<body> HD <hd>": HMMA instructions of that instance of
    ``symbol``} from ``_hmma_counts``."""
    return {f"{body} HD {hd}": sum(
        c for f, c in counts.items() if f"{symbol}ILi{hd}ELb{flag}E" in f)
        for hd in hds for body, flag in (("bias", 1), ("no_bias", 0))}


def _fused_mha_record(torch, g) -> dict:
    """fused_mha's f32 bodies (``_fused_mha_at``) at the WavLM serving shape
    (64 clips x two 2 s windows = 128 rows of 99 frames, 768 wide, 12
    heads) and at head width 80 (hubert-xlarge's: 16 windows, 1,280 wide,
    16 heads), timed, plus T = 600 and 1,500 correctness points; the
    bias-free body also at the other shapes its path launches take
    (F32_NO_BIAS_PATHS: whisper-large-v3's forward, a rank of the mesh's
    TP encoder). Each body's HD = 64 and 80 instances must hold TF32 HMMA
    instructions."""
    f32 = torch.float32
    counts = _hmma_counts("fused_mha", form="TF32")
    hmma = _hmma(counts, "mha_kernel")
    if counts:
        print(f"fused_mha SASS (cuobjdump): TF32 HMMA instructions {hmma}")
        if min(hmma.values()) <= 0:
            raise AssertionError(f"a fused_mha body has no TF32 HMMA "
                                 f"instruction: {hmma}")
    else:
        print("fused_mha SASS: cuobjdump not found, HMMA not counted")
    checks = [_fused_mha_at(torch, g, shape, f32, bias, timed=False)
              for shape in ((4, 600, 768, 12), (2, 1500, 768, 12))
              for bias in (False, True)]
    recs = {(shape, body): _fused_mha_at(torch, g, shape, f32,
                                         body == "bias")
            for shape in ((128, 99, 768, 12), (16, 99, 1280, 16))
            for body in ("no_bias", "bias")}
    paths = {key: _fused_mha_at(torch, g, shape, f32, False, iters=10)
             for key, (shape, _) in F32_NO_BIAS_PATHS.items()}
    every = checks + list(recs.values()) + list(paths.values())
    rec = dict(recs[((128, 99, 768, 12), "bias")])
    rec.update(
        route="cuda", source="radad_tpu_torch/csrc/fused_mha.cu",
        replaces="radad_tpu/ops/attention.py:134",
        max_abs_err=max(r["max_abs_err"] for r in every),
        max_rel_err=max(r["max_rel_err"] for r in every),
        tolerance="1e-5 * (1 + |plain|) (3xTF32 products, f32 summation "
                  "order, online softmax)",
        shape="q,k,v [128,99,768] f32, 12 heads, gate [128,99,12], pos_bias "
              "[12,99,99] (bias body; no_bias: the same without; hd80: "
              "[16,99,1280], 16 heads; T = 600 and 1,500 checked too)",
        bound_rate="3xTF32: 3 x products at the TF32 tensor-core rate, "
                   "495 TFLOP/s",
        no_bias=recs[((128, 99, 768, 12), "no_bias")],
        library_call="F.scaled_dot_product_attention, bias materialized",
        hmma=hmma if counts else None,
        hd80={body: r for (shape, body), r in recs.items()
              if shape[3] == 16})
    for key, (shape, what) in F32_NO_BIAS_PATHS.items():
        b, t, d, h = shape
        rec[key] = dict(shape=f"q,k,v [{b},{t},{d}] f32, {h} heads, no "
                              f"bias ({what})", **paths[key])
    return rec


def _bf16_steps(err, want) -> float:
    """The largest error in bf16 steps of the output: |err| over the bf16
    spacing at |plain| (2^(floor(log2 |plain|) - 7)), over entries with
    |plain| >= 2^-4 (below, a step is smaller than the f32 sums' own
    spread)."""
    keep = want.abs() >= 2.0 ** -4
    step = 2.0 ** (want.abs()[keep].log2().floor() - 7)
    return float((err[keep] / step).max()) if bool(keep.any()) else 0.0


def _fused_mha_bf16_record(torch, g) -> dict:
    """fused_mha's bf16 bodies (the mixed-precision encoders' attention,
    ``_fused_mha_at``) at the WavLM serving shape [128, 99, 768] (12 heads)
    and at head width 80 ([16, 99, 1280], 16 heads), timed beside the
    streamed form on the same inputs, plus T = 600 and 1,500 correctness
    points. BF16_TOL is a bf16 rounding of the output, ~2 steps at |plain|
    ~ 1; the CPU emulation of the kernel's rounding stays within 5.2e-3
    and its faults miss it. Both bodies' instances must hold bf16
    tensor-core instructions in both forms: the resident form that
    T <= 128 takes (HD 64, 80; HMMA) and the streamed form (HD 64: HGMMA,
    HD 80 and 128: HMMA; the resident form at HD 64 without bias: HGMMA,
    and its mma.sync kernel, timed beside it, HMMA); the streamed HD 64
    instances must not spill."""
    from radad_tpu_torch.ops.attention import BF16_TOL

    bf = torch.bfloat16
    counts = _hmma_counts("fused_mha", form="BF16")
    hmma = {f"{body} HD {hd} {form}": sum(
        n for fn, n in counts.items()
        if _bf16_instance(form, hd, body == "bias") in fn)
        for form, hds in (("resident", (64, 80)), ("streamed", (64, 80, 128)))
        for hd in hds for body in ("bias", "no_bias")}
    mma64 = f"{BF16_FORMS['resident'][0]}ILi64ELb0E"
    hmma["no_bias HD 64 resident_mma"] = sum(
        n for fn, n in counts.items() if mma64 in fn)
    if counts:
        print(f"fused_mha bf16 SASS (cuobjdump): bf16 HMMA / HGMMA "
              f"instructions {hmma}; the resident form's wgmma kernel by "
              f"keys of S: " + ", ".join(
                  f"N={fn.split('ILi')[1].split('E')[0]} {n} HGMMA"
                  for fn, n in counts.items() if BF16_FORMS["resident"][1]
                  in fn))
        if min(hmma.values()) <= 0:
            raise AssertionError(f"a bf16 fused_mha body (or its symbol) has "
                                 f"no bf16 HMMA instruction: {hmma}")
    else:
        print("fused_mha bf16 SASS: cuobjdump not found, HMMA not counted")
    _resident_spills()
    streamed_ptxas = _streamed_ptxas()
    checks = [_fused_mha_at(torch, g, shape, bf, bias, timed=False)
              for shape in ((4, 600, 768, 12), (2, 1500, 768, 12))
              for bias in (False, True)]
    recs = {}
    for shape in ((128, 99, 768, 12), (16, 99, 1280, 16)):
        for body in ("no_bias", "bias"):
            recs[shape, body] = r = _fused_mha_at(
                torch, g, shape, bf, body == "bias", streamed=True)
            r["hmma"] = (hmma[f"{body} HD {shape[2] // shape[3]} resident"]
                         if counts else None)
    every = checks + list(recs.values())
    rec = dict(recs[(128, 99, 768, 12), "bias"])  # the headline body
    rec.update(
        route="cuda", source="radad_tpu_torch/csrc/fused_mha.cu",
        replaces="radad_tpu/ops/attention.py:134",
        max_abs_err=max(r["max_abs_err"] for r in every),
        max_rel_err=max(r["max_rel_err"] for r in every),
        max_bf16_steps=max(r["max_bf16_steps"] for r in every),
        tolerance=f"{BF16_TOL} * (1 + |plain|) in f32 (normalized weights "
                  f"rounded to bf16 as the Pallas body; bf16 output)",
        shape="q,k,v [128,99,768] bf16, 12 heads, gate [128,99,12], pos_bias "
              "[12,99,99] bf16 (bias body; no_bias: without; hd80: "
              "[16,99,1280], 16 heads; T = 600 and 1,500 checked too)",
        bound_rate="bf16 989 TFLOP/s (one Q K^T and one P V)",
        library_call="F.scaled_dot_product_attention on the bf16 inputs, "
                     "bias materialized in bf16",
        no_bias=recs[(128, 99, 768, 12), "no_bias"],
        streamed_ptxas=streamed_ptxas,
        hd80={body: r for (shape, body), r in recs.items()
              if shape[3] == 16})
    return rec


def _bias_gelu_record(torch, g) -> dict:
    """``bias_gelu`` at ``BIAS_GELU_SHAPES``: the FFNs' hidden states (bias
    along the last axis), the convs' outputs (bias along the channels;
    conv2's T = 1,500 is not a multiple of 8) and wav2vec2's bias-free
    first conv, each equal bit for bit to its plain version (the op-by-op
    chain), timed beside it and beside the library's ``x + b`` then
    ``F.gelu(approximate="tanh")`` (two kernels, one rounding each: not the
    chain's bits); bound: x read and the output written once, 4 bytes an
    element, at 3.35 TB/s; the launches of one call. → record (whisper's
    FFN) with ``by_shape``."""
    import torch.nn.functional as F

    from radad_tpu_torch.ops.bias_gelu import bias_gelu, bias_gelu_plain

    by_shape = {}
    for key, (shape, axis) in BIAS_GELU_SHAPES.items():
        x = (2 * torch.randn(shape, generator=g, device=g.device)).to(
            torch.bfloat16)
        channel_axis = axis == 1
        b = None if axis is None else torch.randn(
            shape[axis], generator=g, device=g.device).to(torch.bfloat16)
        lib_b = 0 if b is None else b[:, None] if channel_axis else b
        before = bias_gelu.launches
        got = bias_gelu(x, b, channel_axis)
        launches = bias_gelu.launches - before
        want = bias_gelu_plain(x, b, channel_axis)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"bias_gelu {key} {list(shape)} differs from "
                                 f"the op-by-op chain")
        del got, want
        rec = timings(torch, lambda: bias_gelu(x, b, channel_axis),
                      lambda: bias_gelu_plain(x, b, channel_axis),
                      lambda: F.gelu(x + lib_b, approximate="tanh"), iters=10)
        rec["bound_ms"], rec["bound_by"] = bound_ms(4 * x.numel())
        rec.update(dims=list(shape), launches_a_call=launches, bias_axis=axis)
        by_shape[key] = rec
        print(f"bias_gelu {key} {list(shape)}: device {rec['ms']:.4f} ms "
              f"(call {rec['call_ms']:.4f}), bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_ms'] / rec['ms']:.2f} of it), plain (the chain) "
              f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, "
              f"{launches} launch(es); bits equal")
        del x
        torch.cuda.empty_cache()
    return dict(route="cuda", source="radad_tpu_torch/csrc/bias_gelu.cu",
                replaces="the bf16 bias add + tanh GELU op by op "
                         "(models/encoder_common.py)",
                max_abs_err=0.0, tolerance="equal bits",
                bound_rate="bytes, 3.35 TB/s",
                shape=f"[128,1500,2048] bf16, bias on the last axis "
                      f"(by_shape: {', '.join(BIAS_GELU_SHAPES)})",
                **by_shape["ffn"], by_shape=by_shape)


def _channel_ln_gelu_at(torch, g, shape) -> dict:
    """``channel_ln_gelu`` on a seeded bf16 ``shape`` with a conv bias,
    channels-last as the port's front-end convs write it, held to the
    chain by ``compare_with_chain`` (every element within one bf16 step of
    the chain's LayerNorm output, or near 0 within the f32 reordering's
    band of it), timed beside the chain on the row-major tensor (the front
    end before the kernel) and beside the library's bias add,
    ``F.layer_norm`` and ``F.gelu`` (tanh) on the ``[B, T, C]`` rows;
    bound: x read and the output written once, 4 bytes an element, at
    3.35 TB/s."""
    import torch.nn.functional as F

    from radad_tpu_torch.ops.channel_ln_gelu import (channel_ln_gelu,
                                                     channel_ln_gelu_plain,
                                                     compare_with_chain)

    bb, c, t = shape
    dev = g.device
    rows = (3 * torch.randn((bb, t, c), generator=g, device=dev) + 0.5).to(
        torch.bfloat16)
    x = rows.transpose(1, 2)  # channels-last [B, C, T]
    x_rm = x.contiguous()
    b = (torch.randn(c, generator=g, device=dev) / 2).to(torch.bfloat16)
    scale = 1 + torch.randn(c, generator=g, device=dev) / 4
    shift = torch.randn(c, generator=g, device=dev) / 4
    before = channel_ln_gelu.launches
    got = channel_ln_gelu(x, b, scale, shift)
    launches = channel_ln_gelu.launches - before
    torch.cuda.synchronize()
    held = compare_with_chain(got, x, b, scale, shift)
    if held["off"] or got.stride() != x.stride():
        raise AssertionError(f"channel_ln_gelu {list(shape)}: off the "
                             f"chain: {held}")
    del got
    scale_lib, shift_lib = scale.to(torch.bfloat16), shift.to(torch.bfloat16)
    rec = timings(torch, lambda: channel_ln_gelu(x, b, scale, shift),
                  lambda: channel_ln_gelu_plain(x_rm, b, scale, shift),
                  lambda: F.gelu(F.layer_norm(rows + b, (c,), scale_lib,
                                              shift_lib, 1e-5),
                                 approximate="tanh"), iters=10)
    rec["bound_ms"], rec["bound_by"] = bound_ms(4 * x.numel())
    rec.update(dims=list(shape), launches_a_call=launches,
               bits_apart=held["bits_apart"] / x.numel(),
               off_one_step=held["off_one_step"],
               band_ratio=held["band_ratio"],
               max_abs_err=held["max_abs_err"])
    del rows, x, x_rm
    torch.cuda.empty_cache()
    return rec


def _frontend_routes(torch, model, wav) -> dict:
    """Device ms of the layer-normed front end of ``model`` on ``wav`` by
    two routes: "kernel" (``feature_encoder``: each conv channels-last,
    ``conv1d_channels_last``, then the kernel) and "chain" (each conv
    row-major, then ``channel_ln_gelu_plain``: the front end before the
    kernel); with each route's peak memory, its output's largest
    difference from the chain's relative to the chain's largest value, and
    its kernel launches."""
    from radad_tpu_torch.models import encoder_common as C
    from radad_tpu_torch.models import wav2vec2 as W2
    from radad_tpu_torch.ops import channel_ln_gelu as CLG

    cfg, bf16 = model.cfg, torch.bfloat16

    def chain():
        x = wav.to(bf16)[:, None, :]
        for i, layer in enumerate(model.conv_layers):
            x = C.conv1d(x, layer["kernel"], None, cfg.conv_stride[i], 0)
            x = CLG.channel_ln_gelu_plain(x, layer["bias"].to(bf16),
                                          layer["norm_scale"],
                                          layer["norm_bias"])
        return x.transpose(1, 2)

    routes = {"kernel": lambda: W2.feature_encoder(model, wav.to(bf16)),
              "chain": chain}
    out = {}
    with torch.no_grad():
        want = chain().float()
        for name, fn in routes.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            CLG.reset_counts()
            diff = (fn().float() - want).abs().max() / want.abs().max()
            out[name] = dict(launches=CLG.channel_ln_gelu.launches,
                             peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                             rel_diff=float(diff))
            out[name]["ms"] = timed_ms(torch, fn, iters=5)[0]
    CLG.reset_counts()
    return out


def _channel_ln_gelu_record(torch, dev, g) -> dict:
    """``channel_ln_gelu`` at ``CHANNEL_LN_GELU_SHAPES`` (``_channel_ln_
    gelu_at``); the front end of a seeded WavLM-Large at its published
    widths on 128 windows of 2 s by two routes (``_frontend_routes``). →
    record (conv 0) with ``by_shape`` and ``frontend``; its max_abs_err is
    the largest |kernel - chain| over the shapes. The launches on the
    serving path: ``wavlm_large_bf16_phase``."""
    from radad_tpu_torch.models import wav2vec2 as W2
    from radad_tpu_torch.models import wavlm as WL
    from radad_tpu_torch.models.encoder import resolve_arch_config
    from radad_tpu_torch.ops import channel_ln_gelu as CLG

    by_shape = {}
    for key, shape in CHANNEL_LN_GELU_SHAPES.items():
        by_shape[key] = rec = _channel_ln_gelu_at(torch, g, shape)
        print(f"channel_ln_gelu {key} {list(shape)}: device {rec['ms']:.4f} "
              f"ms (call {rec['call_ms']:.4f}), bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bound_ms'] / rec['ms']:.2f} of it), plain (the "
              f"chain) {rec['plain_ms']:.4f} ms, library (add, F.layer_norm, "
              f"F.gelu tanh) {rec['library_ms']:.4f} ms, "
              f"{rec['launches_a_call']} launch(es); held to the chain, bits "
              f"apart on {rec['bits_apart']:.3e}, more than one bf16 step of "
              f"y on {rec['off_one_step']}, all within "
              f"{rec['band_ratio']:.3f} of the band near 0, max |kernel - "
              f"chain| {rec['max_abs_err']:.3e}")
    cfg = resolve_arch_config("microsoft/wavlm-large", kind="wavlm")
    model = WL.init_params(WL.WavLMModel(cfg),
                           torch.Generator().manual_seed(SEED)).to(dev)
    wav = torch.randn((128, 32000), generator=g, device=dev) / 10
    frontend = _frontend_routes(torch, model, wav)
    print("wavlm-large front end, 128 windows, the port's route: "
          + _kernel_breakdown(torch, lambda: W2.feature_encoder(
              model, wav.to(torch.bfloat16)), iters=3, top=10))
    print("wavlm-large front end, 128 windows of 2 s, by route: " + "; ".join(
        f"{k} {v['ms']:.4f} ms, peak {v['peak_gb']:.3f} GB, "
        f"max |diff| {v['rel_diff']:.3e} of the chain's, kernel launches "
        f"{v['launches']}" for k, v in frontend.items()))
    if frontend["kernel"]["launches"] != 7:
        raise AssertionError(f"wavlm-large front end: want 7 kernel "
                             f"launches: {frontend}")
    del model, wav
    CLG.reset_counts()
    torch.cuda.empty_cache()
    return dict(route="cuda", source="radad_tpu_torch/csrc/channel_ln_gelu.cu",
                replaces="the layer-normed front end's bias add, f32 "
                         "LayerNorm through a transpose and GELU op by op "
                         "(ops/channel_ln_gelu.py::channel_ln_gelu_plain)",
                max_abs_err=max(r["max_abs_err"] for r in by_shape.values()),
                tolerance="every element the GELU of the chain's bf16 "
                          "LayerNorm output y or of one of y's two bf16 "
                          "neighbours, or near 0 within 2^-21 of the "
                          "column's terms of the chain's f32 output (f32 "
                          "summation order)",
                bound_rate="bytes, 3.35 TB/s",
                shape=f"[128,512,6399] bf16 channels-last with a conv bias "
                      f"(by_shape: "
                      f"{', '.join(CHANNEL_LN_GELU_SHAPES)})",
                **{k: v for k, v in by_shape["conv0"].items()
                   if k != "max_abs_err"},
                by_shape=by_shape, frontend=frontend)


def _whisper_kernel_records(torch, dev, g) -> dict:
    """The kernels at whisper-base's serving shapes: ``fused_mha``'s
    bias-free f32 body and its bf16 body (the streamed form, which
    T = 1,500 takes) at [16, 1500, 512] and [128, 1500, 512], 8 heads of
    64 (B = 8 and 64 clips of two windows padded to 30 s), by
    ``_fused_mha_at`` (there the bound is the operations: one Q K^T and
    one P V at the bf16 or TF32 rate), with TFLOP/s;
    the bf16 body at the trimmed shapes [16 | 128, 100, 512] (the resident
    form, timed beside its mma.sync kernel and the streamed form);
    ``gather_rows`` at M = 5, 40, 320 and ``exact_dot`` at B = 1, 8, 64
    (R = 32) on a [25,600, 3,584] f32 table (TPP of 512-wide features), as
    the serving path gives them, and at B = 128, 256 (the train and eval
    batches' B at this width, for the forms' threshold), each form checked
    on f32, bf16 and int8 rows. → {kernel: {shape: record}}."""
    from radad_tpu_torch.ops.attention import bf16_form

    out = {"fused_mha": {}, "fused_mha_bf16": {}, "gather_rows": {},
           "exact_dot": {}}
    d, h = 512, 8
    if any(bf16_form(t, d // h) != "streamed" for _, t in WHISPER_ATTN):
        raise AssertionError("fused_mha bf16 at T = 1,500 is not the "
                             "streamed form")
    for b, t in WHISPER_ATTN:
        for name, dt in (("fused_mha", torch.float32),
                         ("fused_mha_bf16", torch.bfloat16)):
            out[name][f"[{b},{t},{d}]"] = rec = _fused_mha_at(
                torch, g, (b, t, d, h), dt, False, iters=10)
            # one Q K^T and one P V: 4 B H T^2 HD operations
            flop = 4.0 * b * h * t * t * (d // h)
            rec["tflops"] = flop / rec["ms"] / 1e9
            rec["library_tflops"] = flop / rec["library_ms"] / 1e9
            print(f"{name} [{b},{t},{d}]: {rec['tflops']:.1f} TFLOP/s, "
                  f"SDPA {rec['library_tflops']:.1f}; "
                  f"{rec['ms'] / rec['library_ms']:.2f}x SDPA's time, "
                  f"{rec['ms'] / rec['bound_ms']:.2f}x the bound")
            torch.cuda.empty_cache()

    # trimmed whisper-base (--whisper_fast, T = 100): the bf16 resident form
    # beside its mma.sync kernel, the streamed form and flash
    for b, t in WHISPER_FAST_ATTN:
        out["fused_mha_bf16"][f"[{b},{t},{d}]"] = _fused_mha_at(
            torch, g, (b, t, d, h), torch.bfloat16, False, streamed=True)

    n, dw, r = INDEX_ROWS, 3_584, 32
    table = torch.randn((n, dw), generator=g, device=dev)
    tables = _row_types(torch, table, g)
    for bb in EXACT_DOT_SERVING_B:
        m = 5 * bb
        out["gather_rows"][f"M={m}"] = rec = _gather_record(torch, table, m,
                                                            g)
        rec["max_abs_err"] = 0.0
        print(f"D={dw}: gather_rows M={m} device {rec['ms']:.4f} ms "
              f"(index_select {rec['library_ms']:.4f}, bound "
              f"{rec['bound_ms']:.4f}, plain {rec['plain_ms']:.4f})")
        q = torch.randn((bb, dw), generator=g, device=dev)
        cidx = torch.randint(0, n, (bb, r), generator=g, device=dev,
                             dtype=torch.int32)
        errs = _exact_dot_forms(torch, q, tables, cidx)
        out["exact_dot"][f"B={bb}"] = rec2 = _exact_dot_record(
            torch, q, table, cidx, samples=21 if bb == 8 else 0)
        rec2["max_abs_err"] = max(errs.values())
        _print_exact_dot(f"D={dw} B={bb}", rec2, errs)
    for bb in EXACT_DOT_TRAIN_B:  # both forms at this width too (threshold)
        q = torch.randn((bb, dw), generator=g, device=dev)
        cidx = torch.randint(0, n, (bb, r), generator=g, device=dev,
                             dtype=torch.int32)
        errs = _exact_dot_forms(torch, q, tables, cidx)
        out["exact_dot"][f"B={bb}"] = rec2 = _exact_dot_record(
            torch, q, table, cidx)
        rec2["max_abs_err"] = max(errs.values())
        _print_exact_dot(f"D={dw} B={bb}", rec2, errs)
    del table, tables
    torch.cuda.empty_cache()
    return out


def _bf16_form_call(qkv, h, extra, form: str):
    """A call of fused_mha's C entry in bf16 with the form given (the
    wrapper picks the form by shape; this times the other one beside it):
    "streamed", "resident", or "resident_mma" (the resident form's
    mma.sync kernel also at head width 64 without bias)."""
    import torch

    from radad_tpu_torch.ops import _native
    from radad_tpu_torch.ops.attention import _FORMS

    q, k, v = qkv
    b, t, d = q.shape
    out = torch.empty_like(q)
    fn = _native.library("fused_mha").radad_fused_mha_bf16
    gate, pos = extra.get("gate"), extra.get("pos_bias")

    def call():
        _native.check_launch("fused_mha", fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if gate is None else gate.data_ptr(),
            None if pos is None else pos.data_ptr(), out.data_ptr(), b, t, d,
            h, RESIDENT_MMA if form == "resident_mma" else _FORMS.index(form),
            _native.stream_of(q)))
        return out
    return call


def _resident_spills() -> None:
    """Raises if ptxas reports a spill in a resident bf16 instance at head
    width 64 or 80 (the shipped encoders; ``header`` prints every line):
    the mma.sync kernel's HD 64 and 80 instances and every instance of the
    wgmma kernel (HD 64 without bias), or if either kernel is missing from
    the report."""
    from radad_tpu_torch.ops import _native

    report = _native.build_reports.get("fused_mha", "")
    mma, wgmma = BF16_FORMS["resident"]
    lines = [(fn, line) for fn, line in ptxas_lines(report)
             if "spill" in line and (wgmma in fn or (
                 mma in fn and ("ILi64E" in fn or "ILi80E" in fn)))]
    for kernel in (mma, wgmma):
        if report and not any(kernel in fn for fn, _ in lines):
            raise AssertionError(f"{kernel} is not in ptxas's report")
    for fn, line in lines:
        if not line.startswith("0 bytes stack frame, 0 bytes spill stores"):
            raise AssertionError(f"resident bf16 instance spills: {fn}: "
                                 f"{line}")


def _streamed_ptxas() -> dict:
    """{"<body> HD <hd>": ptxas's spill and register lines} of the
    streamed bf16 instances at head widths 64 (whisper-base: the wgmma
    kernel) and 128; raises on a spill at HD 64. ptxas's notes that it
    serialized a wgmma kernel's wgmma (the streamed or the resident form's)
    are printed."""
    from radad_tpu_torch.ops import _native

    report = _native.build_reports.get("fused_mha", "")
    out = {}
    for hd in (64, 128):
        for body in ("no_bias", "bias"):
            tag = _bf16_instance("streamed", hd, body == "bias")
            out[f"{body} HD {hd}"] = " | ".join(
                line for fn, line in ptxas_lines(report) if tag in fn)
    for line in report.splitlines():
        for wgmma in (BF16_FORMS["streamed"][1], BF16_FORMS["resident"][1]):
            if wgmma in line and "Performance Loss" in line:
                print(f"ptxas note on {wgmma}: {line.strip()}")
    print(f"fused_mha bf16 streamed form, ptxas: {out}")
    if report and not all(out.values()):
        raise AssertionError("a streamed bf16 instance is missing from "
                             "ptxas's report")
    for key, text in out.items():
        if "HD 64" in key and "0 bytes spill stores, 0 bytes spill loads" \
                not in text:
            raise AssertionError(f"streamed bf16 instance spills: {key}: "
                                 f"{text}")
    return out


def _hmma_counts(name: str, form: str = "") -> dict:
    """Tensor-core instructions (HMMA, mma.sync; HGMMA, wgmma), of the
    operand type ``form`` where given (e.g. "TF32"), in each function of
    the built library of kernel ``name``'s SASS, from ``cuobjdump -sass``
    where the toolkit has it (else {})."""
    import shutil

    from radad_tpu_torch.ops import _native

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run(
        [tool, "-sass", os.path.join(_native.BUILD_DIR, f"lib{name}.so")],
        capture_output=True, text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line) \
                and form in line:
            counts[fn] += 1
    return counts


def _flat_topk_record(torch, dev, g, table) -> dict:
    """flat_topk at the use_pallas search's shape: B = 64 and B = 8 queries
    over the 25,600 x 5,376 f32 table, r = 32 candidates, L2, bf16 scan
    (the tensor-core body), rows past n_valid = 25,000 masked and each
    query of the first half of the 64 excluding the id of its best row; 8
    queries sit next to a row past n_valid, so both masks remove a row that
    would otherwise come first (B = 8 takes queries 28..35: 4 with an
    excluded id, 4 without). Each result is held to the exact (f64) scores
    of the same bf16 operands within the bound of the kernel's tensor-core
    summation order (``ops/topk_check.check_topk``, order "mma"), and to
    the plain version: ids equal except near-ties within that bound, values
    on a shared row within twice it (``compare_topk``). The same kernel
    without the bf16 rounding (its f32 body) must fail the check. Times:
    the wrapper with its merge and the kernel alone (profiler time of the
    kernels named flat_topk), the plain version and the library call.
    The f32 body (``fast_scan=False``) on the same inputs is held the same
    way to ``flat_topk_plain(fast_scan=False)`` within the bound of its own
    summation order (order "chain") and timed beside f32 ``mm`` + |x|^2 +
    mask + ``topk`` (record ``f32_body``; bound at the f32 rate)."""
    from radad_tpu_torch.ops.topk import flat_topk, flat_topk_plain
    from radad_tpu_torch.ops.topk_check import (MMA, check_topk,
                                                compare_topk)

    n, d = table.shape
    b, r, n_valid = 64, 32, 25_000
    q = torch.randn((b, d), generator=g, device=dev)
    past = n_valid + 7 * torch.arange(8, device=dev)
    q[:8] = table[past] + 0.1 * q[:8]
    ids = (torch.arange(n, device=dev) % 5_000).to(torch.int32)
    first = flat_topk_plain(q, table, 1, fast_scan=True)[1][:, 0]
    best = flat_topk_plain(q, table, 1, n_valid=n_valid, fast_scan=True)[1]
    if not torch.equal(first[:8].long(), past):
        raise AssertionError("the rows past n_valid are not the queries' "
                             "nearest: the mask would go untested")
    excl = torch.full((b,), -2, device=dev, dtype=torch.int32)
    excl[: b // 2] = ids[best[: b // 2, 0].long()]
    counts = _hmma_counts("flat_topk")
    hmma = sum(c for f, c in counts.items() if "flat_topk_kernel" in f)
    if counts:
        print(f"flat_topk SASS (cuobjdump): {hmma} HMMA instructions in the "
              f"bf16 body; per function {counts}")
    else:
        print("flat_topk SASS: cuobjdump not found, HMMA not counted")
    if counts and hmma <= 0:
        raise AssertionError("flat_topk's bf16 body has no HMMA instruction")
    recs, f32_body = {}, {}
    for bb, sl in ((64, slice(0, 64)), (8, slice(28, 36))):
        qb, eb = q[sl].contiguous(), excl[sl].contiguous()
        kw = dict(metric="L2", n_valid=n_valid, ids=ids, exclude_ids=eb,
                  fast_scan=True)
        got = flat_topk(qb, table, r, **kw)
        want = flat_topk_plain(qb, table, r, **kw)
        torch.cuda.synchronize()
        held = check_topk(qb, table, got, order=MMA, **kw)
        if not held["ok"]:
            raise AssertionError(f"flat_topk B={bb} fails its exact check: "
                                 f"{held}")
        agree = compare_topk(qb, table, got, want, metric="L2", order=MMA)
        if not agree["ok"]:
            raise AssertionError(f"flat_topk B={bb} disagrees with its plain "
                                 f"version beyond near-ties: {agree}")
        control = check_topk(
            qb, table, flat_topk(qb, table, r, **dict(kw, fast_scan=False)),
            order=MMA, **kw)
        if control["ok"]:
            raise AssertionError("the exact check passes a scan without the "
                                 "bf16 rounding: it is too loose")
        print(f"flat_topk B={bb} vs exact bf16-operand scores (tensor-core "
              f"order): max |err| {held['max_abs_err']:.3e}, largest bound "
              f"{held['max_bound']:.3e}, max(err / bound) "
              f"{held['max_ratio']:.4f}; {held['near_cut']} rows left out "
              f"score above the cut within it; vs plain: "
              f"{agree['rows_differ']} of {bb} rows trade near-tied ids "
              f"(largest exact gap {agree['max_gap']:.3e}), max |value "
              f"diff| on shared rows {agree['max_abs_err']:.3e}; control "
              f"without bf16 rounding fails: max |err| "
              f"{control['max_abs_err']:.3e}, max(err / bound) "
              f"{control['max_ratio']:.2f}")
        mask = ((torch.arange(n, device=dev) >= n_valid)[None, :]
                | (ids[None, :] == eb[:, None]))

        def library(qb=qb, mask=mask):
            s = torch.mm(qb.to(torch.bfloat16), table.to(torch.bfloat16).t(),
                         out_dtype=torch.float32)
            s = 2.0 * s - torch.linalg.vector_norm(table, dim=-1).square()
            return torch.topk(s.masked_fill(mask, float("-inf")), r)

        call = (lambda qb=qb, kw=kw: flat_topk(qb, table, r, **kw))
        rec = dict(
            max_abs_err=agree["max_abs_err"],
            check_max_abs_err=held["max_abs_err"],
            check_max_bound=held["max_bound"],
            check_max_ratio=held["max_ratio"],
            control_max_abs_err=control["max_abs_err"],
            control_max_ratio=control["max_ratio"],
            rows_differ=agree["rows_differ"],
            **timings(torch, call,
                      lambda qb=qb, kw=kw: flat_topk_plain(qb, table, r,
                                                           **kw),
                      library),
            kernel_ms=device_ms(torch, call, name="flat_topk"))
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            n * d * 4 + bb * d * 4 + n * 4 + bb * 4 + bb * r * 8,
            2.0 * bb * n * d, rate=BF16_FLOPS)
        print(f"flat_topk B={bb}: kernel alone {rec['kernel_ms']:.4f} ms, "
              f"wrapper with merge {rec['ms']:.4f} ms on the device, library "
              f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})")
        recs[bb] = rec
        f32_body[f"B={bb}"] = _flat_topk_f32(torch, table, qb, r, kw, mask)
    rec = dict(
        route="cuda", source="radad_tpu_torch/csrc/flat_topk.cu",
        replaces="radad_tpu/ops/topk.py:182",
        tolerance=f"ids equal to plain up to near-ties within the kernel's "
                  f"tensor-core-order f32 rounding bound of the exact "
                  f"bf16-operand scores (largest "
                  f"{recs[64]['check_max_bound']:.3e}; max |err| vs exact "
                  f"{recs[64]['check_max_abs_err']:.3e}), values on shared "
                  f"rows within twice it",
        shape=f"q [{b},{d}] f32, x [{n},{d}] f32, r={r}, L2, bf16 scan "
              f"(b8: the same at B = 8)",
        bound_rate="bf16 989 TFLOP/s",
        library_call="mm(bf16, bf16, out_dtype=f32) + |x|^2 + mask + topk",
        hmma=hmma if counts else None, **recs[64])
    rec["b8"] = recs[8]
    rec["f32_body"] = dict(
        shape=f"the same inputs, fast_scan=False (the SIMT f32 body); "
              f"library: f32 mm + |x|^2 + mask + topk", **f32_body)
    return rec


def _flat_topk_f32(torch, table, qb, r, kw, mask) -> dict:
    """flat_topk's f32 body on ``_flat_topk_record``'s inputs: held to the
    exact scores of the f32 operands within the bound of its FMA-chain
    summation order and to ``flat_topk_plain(fast_scan=False)`` up to
    near-ties; timed (wrapper and kernel alone) beside its plain version
    and f32 ``mm`` + |x|^2 + mask + ``topk``; bound: the table, queries,
    norms and ids read and the candidates written once, against 2 B N D
    operations at the f32 rate."""
    from radad_tpu_torch.ops.topk import flat_topk, flat_topk_plain
    from radad_tpu_torch.ops.topk_check import CHAIN, check_topk, compare_topk

    (n, d), bb = table.shape, qb.shape[0]
    kw = dict(kw, fast_scan=False)
    got = flat_topk(qb, table, r, **kw)
    want = flat_topk_plain(qb, table, r, **kw)
    torch.cuda.synchronize()
    held = check_topk(qb, table, got, order=CHAIN, **kw)
    if not held["ok"]:
        raise AssertionError(f"flat_topk f32 body B={bb} fails its exact "
                             f"check: {held}")
    agree = compare_topk(qb, table, got, want, metric="L2", fast_scan=False,
                         order=CHAIN)
    if not agree["ok"]:
        raise AssertionError(f"flat_topk f32 body B={bb} disagrees with its "
                             f"plain version beyond near-ties: {agree}")

    def library():
        s = 2.0 * torch.mm(qb, table.t()) - torch.linalg.vector_norm(
            table, dim=-1).square()
        return torch.topk(s.masked_fill(mask, float("-inf")), r)

    def call():
        return flat_topk(qb, table, r, **kw)

    rec = dict(max_abs_err=agree["max_abs_err"],
               check_max_abs_err=held["max_abs_err"],
               check_max_bound=held["max_bound"],
               check_max_ratio=held["max_ratio"],
               rows_differ=agree["rows_differ"],
               **timings(torch, call,
                         lambda: flat_topk_plain(qb, table, r, **kw),
                         library),
               kernel_ms=device_ms(torch, call, name="flat_topk"))
    rec["bound_ms"], rec["bound_by"] = bound_ms(
        n * d * 4 + bb * d * 4 + n * 4 + bb * 4 + bb * r * 8,
        2.0 * bb * n * d, rate=F32_FLOPS)
    print(f"flat_topk f32 body B={bb}: vs exact f32-operand scores (chain "
          f"order): max |err| {held['max_abs_err']:.3e}, largest bound "
          f"{held['max_bound']:.3e}, max(err / bound) "
          f"{held['max_ratio']:.4f}; vs plain: {agree['rows_differ']} of "
          f"{bb} rows trade near-tied ids (largest exact gap "
          f"{agree['max_gap']:.3e}); kernel alone {rec['kernel_ms']:.4f} "
          f"ms, wrapper {rec['ms']:.4f} ms, f32 mm + topk "
          f"{rec['library_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def _write_clips(tmp: str, n: int, seed: int, prefix: str):
    """``n`` seeded 3 s synthetic clips as 16-bit WAVs (two spectral
    classes, as the repo's synthetic test set) → (paths, labels)."""
    import numpy as np

    from radad_tpu_torch.data.audio import write_wav

    rng = np.random.default_rng(seed)
    sr, dur = 16_000, 3.0
    t = np.arange(int(sr * dur)) / sr
    paths, labels = [], []
    for i in range(n):
        spoof = i % 3 != 0
        freq = rng.uniform(120.0, 600.0)
        wave = 0.4 * np.sin(2 * np.pi * freq * t + rng.uniform(0, 6.28))
        if spoof:
            wave += 0.3 * np.sin(2 * np.pi * 4 * freq * t)
        wave += 0.02 * rng.standard_normal(len(t))
        path = os.path.join(tmp, f"{prefix}_{i:04d}.wav")
        write_wav(path, wave.astype(np.float32), sr)
        paths.append(path)
        labels.append(1.0 if spoof else 0.0)
    return paths, labels


def _manifest(paths, labels):
    """A Manifest of clips written by ``_write_clips`` (8 speakers)."""
    import numpy as np

    from radad_tpu_torch.data.manifest import Manifest, file_id

    return Manifest(
        paths=tuple(paths), labels=np.asarray(labels, np.float32),
        speakers=tuple(f"spk{i % 8}" for i in range(len(paths))),
        ids=np.asarray([file_id(p) for p in paths], np.int32))


def _pad_index(torch, pipe, n_rows: int, seed: int) -> None:
    """Pad the index to ``n_rows`` with seeded rows around the real clip
    embeddings: one contiguous block of 32 tight clusters x 32 near-
    duplicates (manifest order puts similar clips side by side), the rest
    wider perturbations."""
    ix = pipe.index
    dev = ix.device
    g = torch.Generator(device=dev).manual_seed(seed)
    real = ix.vectors[: ix.n].float()
    std = real.std(0, keepdim=True)
    centers = real[torch.randint(0, ix.n, (32,), generator=g, device=dev)]
    block = (centers.repeat_interleave(32, 0) + 0.05 * std
             * torch.randn((1024, real.shape[1]), generator=g, device=dev))
    rest = n_rows - ix.n - block.shape[0]
    base = real[torch.randint(0, ix.n, (rest,), generator=g, device=dev)]
    wide = base + 0.5 * std * torch.randn((rest, real.shape[1]),
                                          generator=g, device=dev)
    rows = torch.cat([block, wide])
    names = [f"pad_{i:06d}.wav" for i in range(rows.shape[0])]
    labels = (torch.rand((rows.shape[0],), generator=g, device=dev)
              > 0.5).float().tolist()
    ix.add(rows, labels, names)


def _embed_paths(torch, pipe, paths):
    """The pipeline's clip embeddings ``[B, D]`` of ``paths``."""
    import numpy as np

    from radad_tpu_torch.data.audio import load_audio

    cfg = pipe.config
    waves = np.stack([load_audio(p, sample_rate=cfg.sample_rate,
                                 duration=cfg.clip_duration) for p in paths])
    return pipe._embed(torch.as_tensor(waves, device=pipe.device))


def _f64_distances(torch, ix, tpp, mask, k):
    """f64 squared distances ``[B, cap]`` of ``tpp`` to the index rows (inf
    where ``mask``), their top-k (ids, -distances), |q|^2 and |x|^2."""
    from radad_tpu_torch.ops.topk import top_k_stable

    q64, x64 = tpp.double(), ix.vectors.double()
    qsq, xsq = q64.square().sum(-1), x64.square().sum(-1)
    d64 = (qsq[:, None] - 2.0 * q64 @ x64.t() + xsq[None, :]).masked_fill(
        mask, float("inf"))
    neg_ref, ref = top_k_stable(-d64, k)
    return d64, ref, neg_ref, qsq, xsq


def _exclusion_mask(torch, ix, excl, mode: str):
    """Rows a search may not return: past n, and those whose id the query
    excludes ("self": its own; "batch": any of the batch's)."""
    invalid = torch.arange(ix.vectors.shape[0], device=ix.device) >= ix.n
    if mode == "self":
        return invalid[None, :] | (ix.ids[None, :] == excl[:, None])
    hit = invalid | torch.isin(ix.ids, excl)
    return hit[None, :].expand(excl.shape[0], -1)


def _f64_scan(torch, pipe, paths):
    """The f64 full-scan oracle over the pipeline's embeddings of
    ``paths``, each row excluding its own file (predict_batch's "self"
    mode). → (tpp [B, D] f32, exclude ids [B], d64 [B, cap] squared
    distances (inf where masked), ref [B, k] ids, -ref distances, |q|^2,
    |x|^2)."""
    from radad_tpu_torch.data.manifest import file_id

    cfg, ix = pipe.config, pipe.index
    tpp = _embed_paths(torch, pipe, paths)
    excl = torch.as_tensor([file_id(p) for p in paths], device=ix.device,
                           dtype=torch.int32)
    mask = _exclusion_mask(torch, ix, excl, "self")
    return (tpp, excl) + _f64_distances(torch, ix, tpp, mask, cfg.top_k)


def _rows_of(torch, pipe, outs):
    """Index rows of predict_batch's neighbors ``[B, k]``."""
    ix = pipe.index
    name_to_row = {os.path.basename(p): i for i, p in enumerate(ix.paths)}
    return torch.as_tensor([[name_to_row[f] for f in o["retrieved_files"]]
                            for o in outs], device=ix.device)


def _dot_rounding(torch, ix, q, rows):
    """Per query, the largest f32 rounding error that the search's L2 score
    ``|q|^2 - 2 q.x + |x|^2`` can carry from its two sums over D terms that
    differ between the index rows ``rows [B, r]``: |x|^2 and q.x, in any
    summation order, in Higham and Mary's probabilistic form sqrt(D) u
    sum_d |term_d| (u = 2^-24), i.e. sqrt(D) 2^-24 (|x|^2 + 2 sum_d |q_d
    x_d|), in f64 from the inputs alone. |q|^2, one sum for all of a
    query's rows, leaves their order as it is. → [B] f64."""
    x = ix.vectors[rows.long()].double()  # [B, r, D]
    terms = x.square().sum(-1) + 2.0 * (x.abs() * q.double().abs()[:, None]
                                        ).sum(-1)
    return (q.shape[-1] ** 0.5 * 2.0 ** -24 * terms).amax(-1)


def _hold_to_f64(torch, ix, tpp, mask, got, k):
    """Neighbor rows ``got [B, k]`` of queries ``tpp`` against a full scan
    on the card in f64 with the same ``mask``. Ids must be identical,
    except that neighbors whose f64 squared distances differ by less than
    the search's f32 score resolves may swap: there the returned
    neighbors' f64 distances must equal the f64 top-k's at every rank
    within that bound. The search ranks by ``|q|^2 - 2 q.x + |x|^2`` in f32
    (q.x from ``exact_dot``, or from the f32 GEMM of the fallback scan);
    the bound, from the inputs alone, is 2^-21 (|q|^2 + max |x|^2) for the
    rounding of the three terms' sum, plus twice ``_dot_rounding`` over the
    returned and the f64 top-k rows (two rows trade places only within the
    sum of their errors). Returns (rows with identical ids, rows where an
    f32 GEMM full scan's ids differ from the f64 ones, the largest f64 gap
    at a rank, the largest share of its bound that a gap took)."""
    from radad_tpu_torch.index.flat import _full_scan

    d64, ref, neg_ref, qsq, xsq = _f64_distances(torch, ix, tpp, mask, k)
    _, ref32 = _full_scan(tpp, ix.vectors, ix.norms_sq, mask, k,
                          larger_better=False)
    got = got.long()
    tol = (2.0 ** -21 * (qsq + xsq[: ix.n].max())
           + 2.0 * _dot_rounding(torch, ix, tpp, torch.cat([got, ref], 1)))
    gap = (d64.gather(1, got).sort(-1).values + neg_ref).abs().amax(-1)
    if not bool((gap <= tol).all()):  # a NaN fails too
        raise AssertionError(f"neighbors beyond f32 rounding of the f64 "
                             f"top-{k} (excess {float((gap - tol).max()):.3e}"
                             f")")
    same = int((got == ref).all(-1).sum())
    return (same, int((ref32.long() != ref).any(-1).sum()),
            float(gap.max()), float((gap / tol).max()))


def _held_text(held) -> str:
    """``_hold_to_f64``'s counts in words."""
    same, f32_rows, gap, share = held
    return (f"ids identical on {same} (the rest swap neighbors tied within "
            f"f32 rounding); an f32 GEMM full scan's ids differ from f64 on "
            f"{f32_rows} rows; largest f64 gap at a rank {gap:.3e}, "
            f"{share:.3f} of its bound")


def _check_against_full_scan(torch, pipe, paths, outs):
    """Neighbors of ``outs`` (a predict_batch result, per-row self
    exclusion) held to the f64 full scan by ``_hold_to_f64``; logits
    finite. Returns its counts."""
    import numpy as np

    from radad_tpu_torch.data.manifest import file_id

    ix = pipe.index
    tpp = _embed_paths(torch, pipe, paths)
    excl = torch.as_tensor([file_id(p) for p in paths], device=ix.device,
                           dtype=torch.int32)
    counts = _hold_to_f64(torch, ix, tpp,
                          _exclusion_mask(torch, ix, excl, "self"),
                          _rows_of(torch, pipe, outs), pipe.config.top_k)
    if not all(np.isfinite(o["logit"]) for o in outs):
        raise AssertionError("non-finite logit")
    return counts


def _check_against_plain_route(torch, pipe, paths, outs):
    """WavLM phase: the use_pallas search of ``outs`` (predict_batch's
    neighbors) against the same search run through ``flat_topk_plain`` on
    the card (the same embeddings, then the same exact re-rank). The
    kernel's candidates must pass ``check_topk`` and agree with the plain
    candidates up to near-ties (``compare_topk``). The final top-k is
    compared on every row: the f64 squared distances of the two routes'
    neighbors must be equal at every rank within f32 rounding, 2^-21 (|q|^2
    + max |x|^2), as in ``_check_against_full_scan``, unless the rows that
    differ are candidates only one route had (a near-tie at the candidate
    cut, which ``compare_topk`` has bounded). → (rows whose final ids
    differ, rows whose candidate sets differ, recall@k against the f64
    full scan, the check's numbers)."""
    import numpy as np

    from radad_tpu_torch.index.flat import _rerank_exact
    from radad_tpu_torch.ops.topk import flat_topk, flat_topk_plain
    from radad_tpu_torch.ops.topk_check import MMA, check_topk, compare_topk

    ix, k = pipe.index, pipe.config.top_k
    tpp, excl, d64, ref, _, qsq, xsq = _f64_scan(torch, pipe, paths)
    r = min(max(4 * k, 32), ix.vectors.shape[0])
    kw = dict(metric=ix.metric, n_valid=ix.n, ids=ix.ids, exclude_ids=excl,
              fast_scan=True)
    cand_k = flat_topk(tpp, ix.vectors, r, **kw)
    cand_p = flat_topk_plain(tpp, ix.vectors, r, **kw)
    held = check_topk(tpp, ix.vectors, cand_k, order=MMA, **kw)
    if not held["ok"]:
        raise AssertionError(f"flat_topk candidates fail their exact check: "
                             f"{held}")
    agree = compare_topk(tpp, ix.vectors, cand_k, cand_p, metric=ix.metric,
                         order=MMA)
    if not agree["ok"]:
        raise AssertionError(f"flat_topk candidates disagree with "
                             f"flat_topk_plain beyond near-ties: {agree}")
    _, plain_idx = _rerank_exact(tpp, ix.vectors, *cand_p, k,
                                 ix.metric != "L2")
    got, plain_idx = _rows_of(torch, pipe, outs), plain_idx.long()
    tol = 2.0 ** -21 * (qsq + xsq[: ix.n].max())
    off = ((d64.gather(1, got).sort(-1).values
            - d64.gather(1, plain_idx).sort(-1).values).abs()
           > tol[:, None]).any(-1)
    for row in off.nonzero()[:, 0].tolist():
        only = (set(cand_k[1][row].tolist())
                ^ set(cand_p[1][row].tolist()))
        if not set(got[row].tolist()) ^ set(plain_idx[row].tolist()) <= only:
            raise AssertionError(
                f"row {row}: final neighbors {got[row].tolist()} vs the plain "
                f"route's {plain_idx[row].tolist()} differ beyond f32 "
                f"rounding and not by a candidate near-tie")
    if not all(np.isfinite(o["logit"]) for o in outs):
        raise AssertionError("non-finite logit")
    set_rows = (cand_k[1].sort(-1).values
                != cand_p[1].sort(-1).values).any(-1)
    hits = sum(len(set(a) & set(b)) for a, b in zip(got.tolist(),
                                                     ref.tolist()))
    return (int((got != plain_idx).any(-1).sum()), int(set_rows.sum()),
            hits / float(got.numel()), held, agree)


def _build_pipeline(torch, dev, tmp: str, label: str, **cfg_kw):
    """A DetectionPipeline with a seeded random encoder at full width whose
    DB is DB_CLIPS synthetic clips padded to INDEX_ROWS. → (pipeline,
    DB clip paths)."""
    from radad_tpu_torch.config import Config
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    use_pallas = cfg_kw.pop("use_pallas", None)
    root = os.path.join(tmp, label)
    cfg = Config().replace(
        data_root=root, vector_db_path=os.path.join(root, "vdb"),
        train_data_path=os.path.join(root, "db"), use_layer_norm=True,
        use_batch_norm=False, random_seed=SEED, **cfg_kw)
    os.makedirs(cfg.train_data_path)
    t0 = time.perf_counter()
    pipe = DetectionPipeline(cfg, use_pallas=use_pallas, device=dev)
    enc = pipe.encoder.arch_cfg
    print(f"pipeline: {pipe.encoder.name} {enc.num_hidden_layers} layers x "
          f"{pipe.encoder.feature_dim} wide, pretrained="
          f"{pipe.encoder.pretrained}, "
          f"use_pallas={pipe.index.use_pallas}, tpp dim {pipe.tpp_dim}, "
          f"built in {time.perf_counter() - t0:.2f} s")
    db_paths, db_labels = _write_clips(cfg.train_data_path, DB_CLIPS, SEED,
                                       "db")
    manifest = _manifest(db_paths, db_labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.build_vector_database(manifest, save=False)
    torch.cuda.synchronize()
    print(f"build_vector_database: {len(db_paths)} clips in "
          f"{time.perf_counter() - t0:.2f} s")
    _pad_index(torch, pipe, INDEX_ROWS, SEED + 1)
    ix = pipe.index
    print(f"index: {ix.ntotal} x {ix.dimension} {ix.metric}, capacity "
          f"{ix.vectors.shape[0]}, device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return pipe, db_paths


def _launch_counts(kernels, index=None) -> dict:
    """{kernel name: launches} of ``kernels``, of ``bias_gelu`` (with
    "bias_gelu_chain": the bf16 GELUs on the card that ran op by op) and of
    ``channel_ln_gelu`` (with "channel_ln_gelu_chain": the layer-normed
    front ends' bf16 conv layers on the card that ran op by op), with
    exact_dot's per form
    and row type ("exact_dot_split", "exact_dot_int8", ...) and
    extract_candidates' per shape ("extract_candidates_T=8 m=5");
    fused_mha's count splits by dtype: "fused_mha" (its f32 bodies),
    "fused_mha_bf16" (its bf16 bodies). With ``index``, its certified
    searches since ``_reset`` too: "searches" and "fallbacks" (those that
    the certificate failed, whose answer came from the full f32 scan and
    not from ``extract_candidates`` and ``exact_dot``), and "route"; an
    IVF index's gather-route searches also ("gather_searches",
    "gather_fallbacks": those over their chunk budget)."""
    from radad_tpu_torch.ops import bias_gelu as BG
    from radad_tpu_torch.ops import channel_ln_gelu as CLG
    from radad_tpu_torch.ops.attention import fused_mha

    out = {w.__name__: w.launches for w in kernels if w is not fused_mha}
    out["bias_gelu"] = BG.bias_gelu.launches  # every path: the encoders'
    out["bias_gelu_chain"] = BG.bias_gelu_plain.calls
    out["channel_ln_gelu"] = CLG.channel_ln_gelu.launches  # layer-normed
    out["channel_ln_gelu_chain"] = CLG.channel_ln_gelu_plain.calls
    for w in kernels:  # exact_dot's per form and row type;
        if w is fused_mha:  # extract_candidates' per "T=.. m=.."
            continue
        for attr in ("form_launches", "kind_launches", "shape_launches"):
            for key, n in getattr(w, attr, {}).items():
                out[f"{w.__name__}_{key}"] = n
    body = fused_mha.body_launches
    out["fused_mha"] = body["bias"] + body["no_bias"]
    out["fused_mha_bf16"] = body["bias_bf16"] + body["no_bias_bf16"]
    for form, n in fused_mha.form_launches.items():
        out[f"fused_mha_bf16_{form}"] = n
    if index is not None:
        out["searches"], out["fallbacks"] = index.searches, index.fallbacks
        out["route"] = index.route
        if getattr(index, "metric", "") == "IVF":  # its gather route apart
            out["gather_searches"] = index.ivf_gather_searches
            out["gather_fallbacks"] = index.ivf_gather_fallbacks
    return out


def _exact_dot_form_only(launches, label: str, form: str) -> None:
    """The path's exact_dot launches all took ``form``, the one that
    ``exact_dot_form`` names at its B."""
    if launches["exact_dot"] <= 0 or launches[f"exact_dot_{form}"] != \
            launches["exact_dot"]:
        raise AssertionError(f"{label}: exact_dot launched other than the "
                             f"{form} form alone: {launches}")


def _resident_only(launches, label: str) -> None:
    """The path's bf16 attention ran the resident form alone (T = 99)."""
    if (launches["fused_mha_bf16_resident"] <= 0
            or launches["fused_mha_bf16_streamed"]):
        raise AssertionError(f"{label}: fused_mha bf16 launched other than "
                             f"the resident form alone: {launches}")


def _gelu_fused_only(launches, label: str) -> None:
    """Raise unless ``bias_gelu`` ran and no bf16 GELU ran op by op: a bf16
    encoder on the card with no gradient to carry."""
    if launches["bias_gelu"] <= 0 or launches["bias_gelu_chain"] or \
            launches["channel_ln_gelu_chain"]:
        raise AssertionError(f"{label}: want every bf16 GELU in bias_gelu "
                             f"or channel_ln_gelu and none op by op: "
                             f"{launches}")


def _reset(kernels, index=None) -> None:
    """Every launch count of ``kernels``, of ``bias_gelu`` and of
    ``channel_ln_gelu`` (and ``index``'s search counts) to 0."""
    from radad_tpu_torch.ops import (attention, bias_gelu, channel_ln_gelu,
                                     rerank)

    bias_gelu.reset_counts()
    channel_ln_gelu.reset_counts()

    if index is not None:
        index.searches = index.fallbacks = 0
        if hasattr(index, "ivf_gather_searches"):
            index.ivf_gather_searches = index.ivf_gather_fallbacks = 0

    for w in kernels:
        if w is attention.fused_mha:
            attention.reset_launches()
        elif w is rerank.exact_dot:
            rerank.reset_launches()
        else:
            w.launches = 0
            if hasattr(w, "shape_launches"):
                w.shape_launches = {}


def _counted_run(torch, pipe, q_paths, batch64, kernels):
    """5 predict, 5 predict_batch(8), 3 predict_batch(64), with the launch
    counts set to 0 just before and read just after. → (latencies,
    stage_ms, outputs per call kind, launches, fused_mha's per body)."""
    from radad_tpu_torch.ops.attention import fused_mha

    pipe.predict(q_paths[0])  # warm-up outside the counted run
    pipe.predict_batch(q_paths[:8])
    torch.cuda.synchronize()
    _reset(kernels, pipe.index)
    lat = {"predict_1": [], "predict_batch_8": [], "predict_batch_64": []}
    stages, outs = {}, {}
    for _ in range(5):
        t = time.perf_counter()
        outs["predict_1"] = [pipe.predict(q_paths[1])]
        lat["predict_1"].append((time.perf_counter() - t) * 1e3)
    for name, paths, reps in (("predict_batch_8", q_paths[8:16], 5),
                              ("predict_batch_64", batch64, 3)):
        for _ in range(reps):
            t = time.perf_counter()
            outs[name] = pipe.predict_batch(paths)
            lat[name].append((time.perf_counter() - t) * 1e3)
        stages[name] = outs[name][0]["stage_ms"]
    torch.cuda.synchronize()
    launches = _launch_counts(kernels, pipe.index)
    return lat, stages, outs, launches, dict(fused_mha.body_launches)


def _report(lat, stages, pipe, launches, label):
    import numpy as np

    calls = sum(len(v) for v in lat.values())
    summary = {name: {"p50_ms": float(np.median(v)), "runs_ms": v}
               for name, v in lat.items()}
    for name, v in summary.items():
        print(f"{label} {name}: p50 {v['p50_ms']:.2f} ms over "
              f"{len(v['runs_ms'])} runs "
              f"{[round(x, 2) for x in v['runs_ms']]}, stage_ms "
              f"{stages.get(name, '-')}")
    ix = pipe.index
    print(f"{label} serving path: {calls} calls, search route {ix.route}, "
          f"{ix.searches} searches, {ix.fallbacks} fallbacks to the full f32 "
          f"scan; decoder {_decoder()}; kernel launches {launches}")


def _decoder() -> str:
    """The decoder that ``load_audio`` ran: the native library (its path);
    raises if the pure-Python parser ran instead (the card's machine has
    g++)."""
    from radad_tpu_torch.data import audio

    native = audio._try_load_native()
    if not native:
        raise AssertionError("load_audio ran the pure-Python WAV parser: "
                             "the native decoder did not load")
    return f"native ({os.path.relpath(native.path)})"


def _compare_fused(torch, pipe, paths, fused, default, label: str) -> None:
    """predict_batch payloads with and without RADAD_FUSED_ATTENTION=1 on
    the same clips. The embeddings' relative change within 1e-4; the fused
    run's neighbors held to the f64 scan of its own embeddings
    (``_hold_to_f64``); at every rank the two runs' returned distances
    within what the embedding change dq explains, 2 |q - x| |dq| +
    |dq|^2, plus each run's f32 rounding (``_dot_rounding`` over its rows,
    sqrt(D) 2^-24 |q|^2 for the sum of |q|^2) and 2^-20 (|q|^2 + max
    |x|^2); on every row the fused logit within 1e-4 of the fusion model
    run on the default embedding with the fused run's neighbors, so that a
    row whose tied neighbors traded places is held by what the embedding
    change did to its logit, as one whose neighbors stayed. Prints the
    numbers under ``label``."""
    from radad_tpu_torch.data.manifest import file_id

    ix = pipe.index
    base = _embed_paths(torch, pipe, paths)
    os.environ["RADAD_FUSED_ATTENTION"] = "1"
    try:
        moved = _embed_paths(torch, pipe, paths)
    finally:
        os.environ.pop("RADAD_FUSED_ATTENTION", None)
    dq = (moved - base).double().norm(dim=-1)
    drel = float((dq / base.double().norm(dim=-1)).max())
    excl = torch.as_tensor([file_id(p) for p in paths], device=ix.device,
                           dtype=torch.int32)
    rows_f = _rows_of(torch, pipe, fused)
    _hold_to_f64(torch, ix, moved, _exclusion_mask(torch, ix, excl, "self"),
                 rows_f, pipe.config.top_k)

    def returned(outs):
        return torch.tensor([[x["distance"] for x in o["retrieved"]]
                             for o in outs], dtype=torch.float64,
                            device=ix.device)

    d_f, d_d = returned(fused), returned(default)
    q_rounding = 0.0
    for q, outs in ((moved, fused), (base, default)):
        q_rounding = q_rounding + _dot_rounding(
            torch, ix, q, _rows_of(torch, pipe, outs)) + (
            q.shape[-1] ** 0.5 * 2.0 ** -24 * q.double().square().sum(-1))
    # an f32 score may fall below 0 where q and x nearly coincide
    sq_d = torch.maximum(d_f.amax(-1), d_d.amax(-1)).clamp_min(0.0).sqrt()
    tol = (2.0 * sq_d * dq + dq.square() + q_rounding
           + 2.0 ** -20 * (base.double().square().sum(-1)
                           + float(ix.norms_sq[: ix.n].max())))
    off = float(((d_f - d_d).abs() - tol[:, None]).max())
    with torch.no_grad():
        replay = pipe.model(ix.vectors[rows_f].float(), base).float().cpu()
    dlogit = [abs(a["logit"] - b["logit"]) for a, b in zip(fused, default)]
    dreplay = max(abs(a["logit"] - float(r)) for a, r in zip(fused, replay))
    differ = {r for r, (a, b) in enumerate(zip(fused, default))
              if a["retrieved_files"] != b["retrieved_files"]}
    same = max((d for r, d in enumerate(dlogit) if r not in differ),
               default=0.0)
    swapped = max((dlogit[r] for r in differ), default=0.0)
    finite = all(abs(o["logit"]) < float("inf") for o in fused)
    if not (finite and same <= 1e-4 and dreplay <= 1e-4 and drel <= 1e-4
            and off <= 0):  # a NaN fails too
        raise AssertionError(
            f"RADAD_FUSED_ATTENTION=1 changed the result: finite logits "
            f"{finite}, max |dlogit| "
            f"{same:.3e} on rows with equal neighbors, {dreplay:.3e} against "
            f"the default embedding with the same neighbors, relative "
            f"embedding change {drel:.3e}, returned distances beyond their "
            f"bound by {off:.3e} at most")
    print(f"{label} with RADAD_FUSED_ATTENTION=1: neighbors equal on "
          f"{len(fused) - len(differ)} of {len(fused)} rows, the rest swap "
          f"neighbors tied within the embedding change (max relative "
          f"{drel:.3e}, limit 1e-4); returned distances within their bound "
          f"by {-off:.3e}; max |dlogit| {same:.3e} on rows with equal "
          f"neighbors, {swapped:.3e} on the others, {dreplay:.3e} against "
          f"the default embedding with the fused run's neighbors (limits "
          f"1e-4)")


def _decode_compare(paths, reps: int = 5) -> None:
    """Host ms of predict_batch's serial decode loop (``load_audio`` over
    ``paths``) with the native decoder and with the pure-Python parser, in
    turns (native, python, python, native, ...), the median of ``reps``
    each; both must give the same samples."""
    import numpy as np

    from radad_tpu_torch.data import audio

    native = audio._try_load_native()
    times, waves = {"native": [], "python": []}, {}
    try:
        for i in range(2 * reps):
            kind = ("native", "python")[(i + i // 2) % 2]
            audio._native = native if kind == "native" else False
            t0 = time.perf_counter()
            waves[kind] = np.stack([audio.load_audio(p) for p in paths])
            times[kind].append((time.perf_counter() - t0) * 1e3)
    finally:
        audio._native = native
    if not np.array_equal(waves["native"], waves["python"]):
        raise AssertionError("the native decoder's samples differ from the "
                             "Python parser's")
    print(f"decode of {len(paths)} clips (predict_batch's serial loop, host "
          f"ms, median of {reps} in turns): native "
          f"{float(np.median(times['native'])):.3f}, Python parser "
          f"{float(np.median(times['python'])):.3f}; runs native "
          f"{[round(t, 2) for t in times['native']]}, Python "
          f"{[round(t, 2) for t in times['python']]}; samples equal")


def serving_phase(torch, dev, tmp: str):
    """The wav2vec2 serving path at full width, certified search, default
    attention; then one predict_batch(8) with the fused attention switch.
    Returns (pipeline, {path: launches}, query clip paths)."""
    from radad_tpu_torch.ops.attention import fused_mha
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates, flat_topk

    os.environ.pop("RADAD_FUSED_ATTENTION", None)
    torch.cuda.reset_peak_memory_stats()
    pipe, db_paths = _build_pipeline(torch, dev, tmp, "wav2vec2")
    q_paths, q_labels = _write_clips(tmp, 64, SEED + 2, "query")
    batch64 = q_paths[:32] + db_paths[:32]  # half of them are DB clips
    kernels = (gather_rows, exact_dot, extract_candidates, fused_mha,
               flat_topk)
    launches, outs, stages = _serve_checked(torch, pipe, q_paths, batch64,
                                            kernels, "wav2vec2", fused=False)
    _decode_compare(batch64)

    # the same clips with the fused attention switch: bias-free body
    _reset(kernels, pipe.index)
    os.environ["RADAD_FUSED_ATTENTION"] = "1"
    try:
        fused = pipe.predict_batch(q_paths[8:16])
        torch.cuda.synchronize()
    finally:
        os.environ.pop("RADAD_FUSED_ATTENTION", None)
    fused_launches = _launch_counts(kernels, pipe.index)
    body = dict(fused_mha.body_launches)
    if body["no_bias"] <= 0 or body["bias"]:
        raise AssertionError(f"fused attention: bias-free body not launched "
                             f"alone ({body})")
    _compare_fused(torch, pipe, q_paths[8:16], fused,
                   outs["predict_batch_8"], "wav2vec2 predict_batch_8")
    print(f"wav2vec2 with RADAD_FUSED_ATTENTION=1: launches "
          f"{fused_launches}, fused_mha per body {body}")
    # the f32 reference of the mixed-precision phase
    ref = dict(q_paths=q_paths, q_labels=q_labels, db_paths=db_paths,
               batch64=batch64, **_f32_reference(
                   torch, pipe, _serving_sets(q_paths, batch64), outs,
                   stages))
    return pipe, {"wav2vec2": launches,
                  "wav2vec2_fused_attention": fused_launches}, q_paths, ref


def _serving_sets(q_paths, batch64) -> dict:
    """The clips of each counted call kind of ``_counted_run``."""
    return {"predict_1": q_paths[1:2], "predict_batch_8": q_paths[8:16],
            "predict_batch_64": batch64}


def stage_ms(torch, pipe, paths, reps=5):
    """Median milliseconds per stage of one predict_batch's work on
    ``paths``, each stage ended by a device synchronize: decode, embed
    (segment + encoder + TPP), search, neighbor gather, fusion model. An
    SQ8 or IVF pipeline's search stage is its index's ``retrieve``
    (``_retrieve`` as predict_batch calls it: ``retrieve_on_device_sq8``,
    or IVF's gather route or unprobed search), neighbors included (no
    gather stage)."""
    import numpy as np

    from radad_tpu_torch.data.audio import load_audio
    from radad_tpu_torch.data.manifest import file_id
    from radad_tpu_torch.index.flat import _search_device
    from radad_tpu_torch.ops.gather import gather_rows

    cfg, ix = pipe.config, pipe.index
    # SQ8 and IVF: the index's retrieve, neighbors included
    fused = pipe.is_quantized or ix.metric == "IVF"
    stages = (("decode", "embed", "search", "model") if fused
              else ("decode", "embed", "search", "gather", "model"))
    rows = {k: [] for k in stages}
    for _ in range(reps):
        t0 = time.perf_counter()
        waves = np.stack([load_audio(p, sample_rate=cfg.sample_rate,
                                     duration=cfg.clip_duration)
                          for p in paths])
        excl = torch.as_tensor([file_id(p) for p in paths],
                               dtype=torch.int32, device=ix.device)
        audio = torch.as_tensor(waves, device=ix.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tpp = pipe._embed(audio)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            if fused:
                nb = pipe._retrieve(tpp, excl, "self",
                                    prefer_ivf_gather=True)[0]
                torch.cuda.synchronize()
                t3 = t4 = time.perf_counter()
            else:
                _, idx, _ = _search_device(
                    tpp, ix.vectors, ix.ids, excl, cfg.top_k,
                    metric=ix.metric, n_valid=ix.ntotal, xsq=ix.norms_sq,
                    scan_bf16=ix.scan_bf16, resid_bf16=ix.resid_bf16,
                    exclude_mode="self", use_pallas=ix.use_pallas)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                nb = gather_rows(ix.vectors, idx.clamp_min(0).reshape(-1))
                nb = nb.reshape(idx.shape + (ix.dimension,))
                torch.cuda.synchronize()
                t4 = time.perf_counter()
            pipe.model(nb, tpp)
            torch.cuda.synchronize()
            t5 = time.perf_counter()
        for k, a, b in (("decode", t0, t1), ("embed", t1, t2),
                        ("search", t2, t3), ("gather", t3, t4),
                        ("model", t4, t5)):
            if k in rows:
                rows[k].append((b - a) * 1e3)
    return {k: float(np.median(v)) for k, v in rows.items()}


def serving_bf16_phase(torch, dev, tmp: str, ref: dict):
    """The mixed-precision wav2vec2-base serving path at full width
    (use_mixed_precision=True: the encoder and the fusion model in bf16),
    certified search on its own 25,600 x 5,376 index: predict at B = 1,
    predict_batch at B = 8 and 64. Conditions: neighbors equal the f64 scan
    of the bf16 pipeline's own embeddings up to near-ties, the certified
    search's kernels launched, no opt-in kernel; then one predict_batch(8)
    with RADAD_FUSED_ATTENTION=1 must launch fused_mha's bias-free bf16
    body and nothing else of it. Printed: fallbacks, stage times beside the
    f32 phase's, each clip embedding's relative deviation from the f32
    pipeline's (same seeded weights), recall@5 of the bf16 neighbors
    against the f32 pipeline's (by file), and fused against default bf16.
    Returns {path: launches}."""
    from radad_tpu_torch.ops.attention import fused_mha
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates, flat_topk

    os.environ.pop("RADAD_FUSED_ATTENTION", None)
    torch.cuda.reset_peak_memory_stats()
    pipe, db_paths = _build_pipeline(torch, dev, tmp, "wav2vec2_bf16",
                                     use_mixed_precision=True)
    if pipe.encoder.compute_dtype != torch.bfloat16:
        raise AssertionError("use_mixed_precision did not give a bf16 "
                             "encoder")
    q_paths = ref["q_paths"]
    batch64 = q_paths[:32] + db_paths[:32]
    sets = _serving_sets(q_paths, batch64)
    kernels = (gather_rows, exact_dot, extract_candidates, fused_mha,
               flat_topk)
    launches, outs, stages = _serve_checked(
        torch, pipe, q_paths, batch64, kernels, "wav2vec2 bf16", fused=False)
    _against_f32(torch, pipe, "wav2vec2 bf16", sets, outs, stages, ref)

    # the fused attention switch: fused_mha's bias-free bf16 body
    _reset(kernels, pipe.index)
    os.environ["RADAD_FUSED_ATTENTION"] = "1"
    try:
        fused = pipe.predict_batch(sets["predict_batch_8"])
        torch.cuda.synchronize()
        fused_launches = _launch_counts(kernels, pipe.index)
        body = dict(fused_mha.body_launches)
        moved = _embed_paths(torch, pipe, sets["predict_batch_8"])
    finally:
        os.environ.pop("RADAD_FUSED_ATTENTION", None)
    if body["no_bias_bf16"] <= 0 or sum(body.values()) != body["no_bias_bf16"]:
        raise AssertionError(f"bf16 fused attention: the bias-free bf16 body "
                             f"not launched alone ({body})")
    _resident_only(fused_launches, "wav2vec2 bf16 fused attention")
    _gelu_fused_only(fused_launches, "wav2vec2 bf16 fused attention")
    base = _embed_paths(torch, pipe, sets["predict_batch_8"]).double()
    drel = ((moved.double() - base).norm(dim=-1) / base.norm(dim=-1)).max()
    same = sum(a["retrieved_files"] == b["retrieved_files"]
               for a, b in zip(fused, outs["predict_batch_8"]))
    dlogit = max(abs(a["logit"] - b["logit"])
                 for a, b in zip(fused, outs["predict_batch_8"]))
    print(f"wav2vec2 bf16 with RADAD_FUSED_ATTENTION=1: predict_batch(8) "
          f"embeddings within {float(drel):.3e} relative of the default bf16 "
          f"path, neighbors identical on {same} of 8 rows, max |dlogit| "
          f"{dlogit:.3e}; launches {fused_launches}, fused_mha per body "
          f"{body}")
    del pipe
    return {"wav2vec2_bf16": launches,
            "wav2vec2_bf16_fused_attention": fused_launches}


def wavlm_phase(torch, dev, tmp: str, mixed: bool = False):
    """The WavLM serving path at full width: use_pallas=True (flat_topk +
    exact re-rank) and RADAD_FUSED_ATTENTION=1 (fused_mha's bias body).
    ``mixed``: with use_mixed_precision=True (path "wavlm_bf16"), which
    must launch the bias body's bf16 instance. Returns {path: launches}."""
    from radad_tpu_torch.ops.attention import fused_mha
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates, flat_topk

    label = "wavlm_bf16" if mixed else "wavlm"
    body_name, mha_name = (("bias_bf16", "fused_mha_bf16") if mixed
                           else ("bias", "fused_mha"))
    os.environ["RADAD_FUSED_ATTENTION"] = "1"
    try:
        pipe, db_paths = _build_pipeline(
            torch, dev, tmp, label, feature_extractor_type="wavlm",
            use_pallas=True, use_mixed_precision=mixed)
        q_paths, _ = _write_clips(tmp, 64, SEED + 3,
                                  "wquery_bf16" if mixed else "wquery")
        batch64 = q_paths[:32] + db_paths[:32]
        kernels = (gather_rows, exact_dot, extract_candidates, fused_mha,
                   flat_topk)
        lat, stages, outs, launches, body = _counted_run(
            torch, pipe, q_paths, batch64, kernels)
        if body[body_name] <= 0 or sum(body.values()) != body[body_name]:
            raise AssertionError(f"{label}: fused_mha {body_name} body not "
                                 f"launched alone ({body})")
        for name in (mha_name, "flat_topk", "gather_rows"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     f"{label} serving path")
        if mixed:
            _resident_only(launches, label)
        _report(lat, stages, pipe, launches, label)
        print(f"{label} fused_mha per body {body}")
        for name in ("predict_batch_8", "predict_batch_64"):
            paths = q_paths[8:16] if name == "predict_batch_8" else batch64
            differ, sets, recall, held, agree = _check_against_plain_route(
                torch, pipe, paths, outs[name])
            print(f"{label} {name}: candidates within the kernel's rounding "
                  f"bound of the exact scores (max |err| "
                  f"{held['max_abs_err']:.3e}, largest bound "
                  f"{held['max_bound']:.3e}, max(err / bound) "
                  f"{held['max_ratio']:.4f}); {agree['rows_differ']} rows "
                  f"order near-tied candidates differently from "
                  f"flat_topk_plain, {sets} hold other candidate sets; final "
                  f"top-{pipe.config.top_k} ids differ from the plain route "
                  f"on {differ} of {len(paths)} rows, each by a near-tie; "
                  f"recall@{pipe.config.top_k} against the f64 full scan "
                  f"{recall:.4f}")
        if mixed:
            for name, paths in (("predict_batch_8", q_paths[8:16]),
                                ("predict_batch_64", batch64)):
                st = stage_ms(torch, pipe, paths)
                print(f"{label} stages {name} (median of 5, ms): "
                      + ", ".join(f"{k} {v:.3f}" for k, v in st.items()))
    finally:
        os.environ.pop("RADAD_FUSED_ATTENTION", None)
    return {label: launches}


def wavlm_large_bf16_phase(torch, dev, tmp: str):
    """The layer-normed front end on the serving path: a seeded random
    WavLM-Large pipeline at its published widths (conv biases, the
    layer-normed front end) with ``use_mixed_precision=True`` and
    ``RADAD_FUSED_ATTENTION=1``, as wavlm-large-bulk runs it. After a
    warm-up, the launch counts are set to 0 and ``predict_batch`` of 64
    clips runs 3 times, with each encoder forward counted where it enters
    ``feature_encoder``: each must launch ``channel_ln_gelu`` 7 times (one
    a conv layer) and ``bias_gelu`` 25 (the positional conv and the 24
    FFNs), and no bf16 chain may run op by op; the neighbors of the last
    call are held to the f64 scan. Returns {path: launches}."""
    from radad_tpu_torch.models import wav2vec2 as W2
    from radad_tpu_torch.ops.attention import fused_mha
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates, flat_topk

    label = "wavlm_large_bf16"
    os.environ["RADAD_FUSED_ATTENTION"] = "1"
    encoder = W2.feature_encoder
    forwards = []

    def counted(*args, **kwargs):
        forwards.append(args[1].shape[0])
        return encoder(*args, **kwargs)

    try:
        pipe, db_paths = _build_pipeline(
            torch, dev, tmp, label, feature_extractor_type="wavlm",
            wavlm_model_name="microsoft/wavlm-large",
            use_mixed_precision=True)
        q_paths, _ = _write_clips(tmp, 32, SEED + 5, "wlquery")
        batch64 = q_paths + db_paths[:32]
        kernels = (gather_rows, exact_dot, extract_candidates, fused_mha,
                   flat_topk)
        pipe.predict_batch(batch64)  # warm-up outside the counted run
        torch.cuda.synchronize()
        _reset(kernels, pipe.index)
        W2.feature_encoder = counted
        try:
            for _ in range(3):
                outs = pipe.predict_batch(batch64)
            torch.cuda.synchronize()
        finally:
            W2.feature_encoder = encoder
        launches = _launch_counts(kernels, pipe.index)
        n = len(forwards)
        print(f"{label}: 3 predict_batch(64) calls, {n} encoder forwards "
              f"of {forwards} windows; launches {launches}")
        want = dict(channel_ln_gelu=7 * n, channel_ln_gelu_chain=0,
                    bias_gelu=25 * n, bias_gelu_chain=0)
        got = {k: launches[k] for k in want}
        if n < 3 or got != want:
            raise AssertionError(f"{label}: want 7 channel_ln_gelu and 25 "
                                 f"bias_gelu launches a forward and no chain "
                                 f"op by op over {n} forwards, got {got}")
        held = _check_against_full_scan(torch, pipe, batch64, outs)
        print(f"{label} predict_batch_64: neighbors match the f64 full scan "
              f"on all {len(batch64)} rows, {_held_text(held)}")
    finally:
        W2.feature_encoder = encoder
        os.environ.pop("RADAD_FUSED_ATTENTION", None)
    return {label: launches}


def _serve_checked(torch, pipe, q_paths, batch64, kernels, label: str,
                   fused: bool):
    """``_counted_run`` on ``pipe``, then: neighbors of predict_batch(8) and
    (64) against the f64 scan of the pipeline's own embeddings, the
    certified search's kernels launched, fused_mha launched iff ``fused``
    (RADAD_FUSED_ATTENTION=1 set by the caller) and flat_topk not; the
    report, the stage times of each call kind and the peak device memory
    since the caller's reset. → (launches, outputs, {call kind: stage ms})."""
    import numpy as np

    lat, stages, outs, launches, _ = _counted_run(torch, pipe, q_paths,
                                                  batch64, kernels)
    if not np.isfinite(outs["predict_1"][0]["logit"]):
        raise AssertionError(f"{label}: non-finite logit from predict")
    sets = _serving_sets(q_paths, batch64)
    for name in ("predict_batch_8", "predict_batch_64"):
        held = _check_against_full_scan(torch, pipe, sets[name], outs[name])
        print(f"{label} {name}: neighbors match the f64 full scan on all "
              f"{len(sets[name])} rows, {_held_text(held)}")
    for name in ("gather_rows", "exact_dot", "extract_candidates"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{label} serving path")
    _exact_dot_form_only(launches, label, "split")  # B = 1, 8, 64
    bf16 = pipe.encoder.compute_dtype == torch.bfloat16
    if bf16:
        _gelu_fused_only(launches, label)
    elif launches["bias_gelu"]:
        raise AssertionError(f"{label}: want bias_gelu launched iff the "
                             f"encoder is bf16: {launches}")
    attn = launches["fused_mha"] + launches["fused_mha_bf16"]
    if launches["flat_topk"] or bool(attn) != fused:
        raise AssertionError(f"{label}: want fused_mha {'' if fused else 'not '}"
                             f"launched and flat_topk not: {launches}")
    _report(lat, stages, pipe, launches, label)
    _search_costs(torch, pipe, sets, label)
    stage = {n: stage_ms(torch, pipe, p) for n, p in sets.items()}
    for name, st in stage.items():
        print(f"{label} stages {name} (median of 5, ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in st.items()))
    print(f"{label}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, outs, stage


def _search_costs(torch, pipe, sets, label: str) -> None:
    """Prints, on each call kind's clips, the call ms (CUDA events over 10
    calls, each ended by a synchronize as a search's caller reads its
    result: host work included) of the certified search's attempt
    (``_search_fast_exact``: bf16 scan, candidate select, ``exact_dot``,
    the certificate's host read) and of the full f32 scan (``_full_scan``)
    that a failed certificate runs after it, and whether the attempt
    held: what a fallback wastes beside the scan alone."""
    from radad_tpu_torch.data.manifest import file_id
    from radad_tpu_torch.index.flat import _full_scan, _search_fast_exact

    ix, k = pipe.index, pipe.config.top_k
    for name, paths in sets.items():
        tpp = _embed_paths(torch, pipe, paths)
        mask = _exclusion_mask(torch, ix, torch.as_tensor(
            [file_id(p) for p in paths], device=ix.device,
            dtype=torch.int32), "self")

        def attempt():
            out = _search_fast_exact(
                tpp, ix.scan_bf16, ix.norms_sq, mask, k, False, ix.vectors,
                resid_bf16=ix.resid_bf16)
            torch.cuda.synchronize()
            return out

        def scan():
            _full_scan(tpp, ix.vectors, ix.norms_sq, mask, k, False)
            torch.cuda.synchronize()

        held = attempt()[2]
        a_ms, s_ms = time_ms(torch, attempt, 10), time_ms(torch, scan, 10)
        print(f"{label} {name} search (L2, call ms on CUDA events): "
              f"certified attempt {a_ms:.3f} "
              f"({'held' if held else 'failed, wasted'}), full f32 scan "
              f"{s_ms:.3f}")


def _f32_reference(torch, pipe, sets, outs, stages) -> dict:
    """An f32 pipeline's embeddings, neighbor files and stage times per call
    kind, which ``_against_f32`` holds a bf16 pipeline's beside."""
    return dict(emb={n: _embed_paths(torch, pipe, p).cpu()
                     for n, p in sets.items()},
                files={n: [o["retrieved_files"] for o in outs[n]]
                       for n in sets},
                stages=stages)


def _against_f32(torch, pipe, label, sets, outs, stages, ref) -> None:
    """Prints, per call kind, a bf16 pipeline's stage times beside the f32
    pipeline's (``ref`` from ``_f32_reference``), each clip embedding's
    relative deviation from the f32 one and recall@k of the bf16 neighbors
    against the f32 ones (by file)."""
    import numpy as np

    k = pipe.config.top_k
    for name, paths in sets.items():
        emb = _embed_paths(torch, pipe, paths).cpu().double()
        f32 = ref["emb"][name].double()
        dev_rel = ((emb - f32).norm(dim=-1) / f32.norm(dim=-1)).numpy()
        hits = [len(set(a) & set(b)) for a, b in zip(
            (o["retrieved_files"] for o in outs[name]), ref["files"][name])]
        print(f"{label} against f32, {name}: stages bf16 "
              + ", ".join(f"{s} {v:.3f}" for s, v in stages[name].items())
              + "; f32 " + ", ".join(
                  f"{s} {v:.3f}" for s, v in ref["stages"][name].items())
              + f"; embedding relative deviation per clip max "
              f"{dev_rel.max():.3e}, median {float(np.median(dev_rel)):.3e};"
              f" recall@{k} of the bf16 neighbors against the f32 "
              f"pipeline's {sum(hits) / (k * len(hits)):.4f} "
              f"({sum(h == k for h in hits)} of {len(hits)} rows identical "
              f"sets)")


def whisper_phase(torch, dev, tmp: str):
    """whisper-base serving at full width (6 layers, 512 wide, 8 heads of
    64; f32), certified search on a 25,600 x 3,584 index (TPP of 512), in
    the reference's 30 s padding (T = 1,500) with the default attention:
    predict at B = 1 and predict_batch at B = 8 and 64, counted and timed,
    neighbors against the f64 scan; then ``_whisper_fused_check``. Then the
    same serving calls with whisper_pad_seconds=None (T = 100) on its own
    index. Peak device memory per pipeline. Returns ({path: launches}, the
    f32 embeddings, neighbor files and stage times per pad mode for
    ``whisper_bf16_phase``)."""
    import gc

    from radad_tpu_torch.ops.attention import fused_mha
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates, flat_topk

    kernels = (gather_rows, exact_dot, extract_candidates, fused_mha,
               flat_topk)
    os.environ.pop("RADAD_FUSED_ATTENTION", None)
    q_paths, _ = _write_clips(tmp, 64, SEED + 8, "whquery")
    by_path, ref = {}, {"q_paths": q_paths}
    for pad, label in ((30.0, "whisper"), (None, "whisper_fast")):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pipe, db_paths = _build_pipeline(
            torch, dev, tmp, label, feature_extractor_type="whisper",
            whisper_pad_seconds=pad)
        batch64 = q_paths[:32] + db_paths[:32]
        sets = _serving_sets(q_paths, batch64)
        launches, outs, stage = _serve_checked(torch, pipe, q_paths, batch64,
                                               kernels, label, fused=False)
        by_path[label] = launches
        ref[pad] = _f32_reference(torch, pipe, sets, outs, stage)
        if pad is not None:
            by_path["whisper_fused_attention"] = _whisper_fused_check(
                torch, pipe, sets, outs, kernels)
        del pipe, outs
    return by_path, ref


def _whisper_fused_check(torch, pipe, sets, outs, kernels) -> dict:
    """predict_batch(8) and (64) of the padded whisper-base pipeline with
    RADAD_FUSED_ATTENTION=1 must launch fused_mha's bias-free f32 body once
    a layer a call (at [16, 1500, 512] and [128, 1500, 512]) and nothing
    else of it, and agree with the default path's ``outs`` as
    ``_compare_fused`` holds them. → launches."""
    from radad_tpu_torch.ops.attention import fused_mha

    _reset(kernels, pipe.index)
    torch.cuda.reset_peak_memory_stats()
    os.environ["RADAD_FUSED_ATTENTION"] = "1"
    try:
        fused = {n: pipe.predict_batch(sets[n])
                 for n in ("predict_batch_8", "predict_batch_64")}
        torch.cuda.synchronize()
    finally:
        os.environ.pop("RADAD_FUSED_ATTENTION", None)
    launches = _launch_counts(kernels, pipe.index)
    body = dict(fused_mha.body_launches)
    layers = pipe.encoder.arch_cfg.num_hidden_layers
    if body != {"bias": 0, "no_bias": 2 * layers, "bias_bf16": 0,
                "no_bias_bf16": 0}:
        raise AssertionError(f"whisper fused attention: want {2 * layers} "
                             f"bias-free f32 launches, got {body}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for name, got in fused.items():
        _compare_fused(torch, pipe, sets[name], got, outs[name],
                       f"whisper {name}")
    print(f"whisper fused attention: launches {launches}, fused_mha per body "
          f"{body}; peak device memory {peak:.2f} GiB")
    return launches


def whisper_bf16_phase(torch, dev, tmp: str, ref: dict):
    """whisper-base in mixed precision (bf16 encoder and fusion model, f32
    parameters and clip embeddings) with RADAD_FUSED_ATTENTION=1, each pad
    mode on its own 25,600 x 3,584 index: the serving calls of
    ``whisper_phase``, neighbors against the f64 scan of the bf16
    embeddings, fused_mha's bias-free bf16 body alone, in the streamed
    form only at T = 1,500 (30 s padding) and the resident form only at
    T = 100 (trimmed). Printed beside the f32 pipeline of the same pad
    mode: stage times, each clip embedding's relative deviation, recall@5
    of the bf16 neighbors against the f32 ones (by file). Returns {path:
    launches}."""
    import gc

    from radad_tpu_torch.ops.attention import fused_mha
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates, flat_topk

    kernels = (gather_rows, exact_dot, extract_candidates, fused_mha,
               flat_topk)
    q_paths, by_path = ref["q_paths"], {}
    os.environ["RADAD_FUSED_ATTENTION"] = "1"
    try:
        for pad, label in ((30.0, "whisper_bf16"),
                           (None, "whisper_bf16_fast")):
            torch.cuda.reset_peak_memory_stats()
            pipe, db_paths = _build_pipeline(
                torch, dev, tmp, label, feature_extractor_type="whisper",
                whisper_pad_seconds=pad, use_mixed_precision=True)
            if pipe.encoder.compute_dtype != torch.bfloat16:
                raise AssertionError("use_mixed_precision did not give a "
                                     "bf16 encoder")
            batch64 = q_paths[:32] + db_paths[:32]
            sets = _serving_sets(q_paths, batch64)
            launches, outs, stage = _serve_checked(
                torch, pipe, q_paths, batch64, kernels, label, fused=True)
            body = dict(fused_mha.body_launches)
            if body["no_bias_bf16"] <= 0 or sum(body.values()) != body[
                    "no_bias_bf16"]:
                raise AssertionError(f"{label}: the bias-free bf16 body not "
                                     f"launched alone ({body})")
            if pad is None:
                _resident_only(launches, label)
            elif (launches["fused_mha_bf16_streamed"] <= 0
                  or launches["fused_mha_bf16_resident"]):
                raise AssertionError(f"{label}: fused_mha bf16 launched other "
                                     f"than the streamed form alone at "
                                     f"T = 1,500: {launches}")
            if launches["bias_gelu"] <= 0 or launches["bias_gelu"] % 8 or \
                    launches["bias_gelu_chain"]:
                raise AssertionError(f"{label}: want 8 bias_gelu launches a "
                                     f"forward (6 FFNs, 2 convs) and no "
                                     f"GELU op by op: {launches}")
            by_path[label] = launches
            _against_f32(torch, pipe, label, sets, outs, stage, ref[pad])
            del pipe, outs
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("RADAD_FUSED_ATTENTION", None)
    return by_path


def fused_forward_phase(torch, dev, tmp: str, kind: str, model_name: str,
                        label: str):
    """One full-size encoder with seeded random weights: one forward of 8
    two-second windows (hubert-xlarge-ls960-ft: 48 layers, 1,280 wide, 16
    heads of 80) or of 2 (whisper-large-v3: 32 layers, 1,280 wide, 20
    heads of 64, 128 mel bins, T = 1,500 padded to 30 s) with
    RADAD_FUSED_ATTENTION=1 must launch fused_mha's bias-free body once a
    layer and stay within 1e-4 relative of the same forward without it.
    Returns {path: launches}."""
    import gc

    import numpy as np

    from radad_tpu_torch.config import Config
    from radad_tpu_torch.models.encoder import build_encoder
    from radad_tpu_torch.ops.attention import fused_mha
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates, flat_topk

    os.environ.pop("RADAD_FUSED_ATTENTION", None)
    cfg = Config().replace(feature_extractor_type=kind,
                           data_root=os.path.join(tmp, label),
                           **{f"{kind}_model_name": model_name})
    t0 = time.perf_counter()
    enc = build_encoder(cfg, seed=SEED, device=dev)
    arch = enc.arch_cfg
    layers, heads = arch.num_hidden_layers, arch.num_attention_heads
    print(f"{label} encoder: {layers} layers x {enc.feature_dim} wide, "
          f"{heads} heads of {enc.feature_dim // heads}, pretrained="
          f"{enc.pretrained}, built in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 4)
    sr, n = cfg.sample_rate, 2 if kind == "whisper" else 8
    tone = np.sin(2 * np.pi * rng.uniform(120, 600, (n, 1))
                  * np.arange(2 * sr) / sr)
    wave = torch.as_tensor((0.4 * tone + 0.02 * rng.standard_normal(
        tone.shape)).astype(np.float32), device=dev)
    torch.cuda.reset_peak_memory_stats()
    base = enc.segment_features(wave)
    torch.cuda.synchronize()
    kernels = (gather_rows, exact_dot, extract_candidates, fused_mha,
               flat_topk)
    _reset(kernels)
    os.environ["RADAD_FUSED_ATTENTION"] = "1"
    try:
        fused = enc.segment_features(wave)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("RADAD_FUSED_ATTENTION", None)
    launches = _launch_counts(kernels)
    body = dict(fused_mha.body_launches)
    rel = float(((fused - base).double().flatten(1).norm(dim=1)
                 / base.double().flatten(1).norm(dim=1)).max())
    print(f"{label} with RADAD_FUSED_ATTENTION=1: features "
          f"{list(fused.shape)}, max relative change per window {rel:.3e} "
          f"(limit 1e-4), max |diff| {float((fused - base).abs().max()):.3e}"
          f"; launches {launches}, fused_mha per body {body}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if body != {"bias": 0, "no_bias": layers, "bias_bf16": 0,
                "no_bias_bf16": 0}:
        raise AssertionError(f"{label}: want {layers} bias-free fused_mha "
                             f"launches, got {body}")
    if not (rel <= 1e-4 and bool(torch.isfinite(fused).all())):
        raise AssertionError(f"{label}: fused attention moved the features "
                             f"by {rel:.3e} relative")
    del enc, base, fused
    gc.collect()
    torch.cuda.empty_cache()
    return {f"{label}_fused_attention": launches}


def _sq8_cpu(ix) -> dict:
    """The SQ8 index's arrays copied to the CPU, by
    ``retrieve_on_device_sq8``'s keyword names."""
    names = ("codes", "scales", "norm_sq", "labels", "ids", "centroids",
             "cells", "codes2", "scales2")
    return {n: None if getattr(ix, n) is None else getattr(ix, n).cpu()
            for n in names}


def _hold_to_cpu(torch, got_idx, got_d, want_idx, want_d, q, recon, label,
                 flipped=None):
    """A search on the card (neighbor rows ``got_idx`` and distances
    ``got_d``) against the same search run on the CPU copies of the same
    arrays (``want_idx``, ``want_d``). Ids must be identical, except that
    neighbors may swap where the f64 distances of the two lists' rows
    (``recon(rows)``: the rows as the search scores them, f64 on the host)
    agree rank by rank within twice the f32 rounding of the L2 distance's
    sums, from the inputs alone: sqrt(D) 2^-24 (|q|^2 + |x|^2 + 2 sum
    |q_d x_d|) over both lists' rows; distances within 1e-5 relative plus
    that rounding. Queries in ``flipped`` (IVF: a probe that flipped
    within rounding, ``_probe_flips``) are counted and not compared. →
    (rows with identical ids, rows not compared, the largest relative
    distance error, the largest share of its bound that a gap took)."""
    keep = (torch.ones(q.shape[0], dtype=torch.bool) if flipped is None
            else ~flipped.cpu())
    gi, wi = got_idx.cpu().long()[keep], want_idx.cpu().long()[keep]
    skipped = int((~keep).sum())
    if not bool(keep.any()):
        return 0, skipped, 0.0, 0.0
    ok = wi >= 0
    if not torch.equal(gi >= 0, ok):
        raise AssertionError(f"{label}: the card and the CPU return "
                             f"different numbers of neighbors")
    q64 = q.float().cpu().double()[keep]
    xg, xw = recon(gi.clamp_min(0)), recon(wi.clamp_min(0))
    both = torch.cat([xg, xw], 1)
    terms = (q64.square().sum(-1)[:, None] + both.square().sum(-1)
             + 2.0 * (both.abs() * q64.abs()[:, None]).sum(-1)).amax(-1)
    tol = 2.0 * q64.shape[-1] ** 0.5 * 2.0 ** -24 * terms  # [B']
    gd = got_d.cpu().double()[keep]
    wd = want_d.cpu().double()[keep]
    err = (gd - wd).abs().masked_fill(~ok, 0.0)
    if not bool((err <= 1e-5 * wd.abs().masked_fill(~ok, 0.0)
                 + tol[:, None]).all()):
        raise AssertionError(f"{label}: distances on the card differ from "
                             f"the CPU's beyond 1e-5 relative: "
                             f"{float(err.max())}")
    rel = float((err / wd.abs().masked_fill(~ok, 1.0)).max())

    def f64(x):
        return (x - q64[:, None]).square().sum(-1).masked_fill(~ok, 0.0)

    gap = (f64(xg).sort(-1).values - f64(xw).sort(-1).values).abs().amax(-1)
    if not bool((gap <= tol).all()):
        raise AssertionError(f"{label}: neighbors on the card differ from "
                             f"the CPU's beyond f32 rounding (excess "
                             f"{float((gap - tol).max()):.3e})")
    return (int((gi == wi).all(-1).sum()), skipped, rel,
            float((gap / tol).max()))


def _sq8_hold(torch, pipe, cpu, tpp, excl, mode, got_idx, got_d):
    """An SQ8 search on the card (``got_idx``, ``got_d``: neighbor rows and
    distances of the path) against the same function,
    ``retrieve_on_device_sq8``, run on the CPU with the plain kernels on
    the same embeddings ``tpp`` and index arrays (``cpu``), by
    ``_hold_to_cpu``'s rule on the dequantized rows. → (rows with
    identical ids, the largest relative distance error, the largest share
    of its bound that a gap took)."""
    from radad_tpu_torch.index.quantized import (_dequantize,
                                                 retrieve_on_device_sq8)

    ix, k = pipe.index, pipe.config.top_k
    _, _, d_cpu, i_cpu = retrieve_on_device_sq8(
        tpp.float().cpu(), cpu["codes"], cpu["scales"], cpu["norm_sq"],
        cpu["labels"], cpu["ids"], excl.cpu(), k=k, metric=ix.metric,
        n_valid=ix.ntotal, accel=ix.build_accel, exclude_mode=mode,
        centroids=cpu["centroids"], cells=cpu["cells"],
        codes2=cpu["codes2"], scales2=cpu["scales2"])

    def recon(rows):
        x = _dequantize(rows.reshape(-1), cpu["codes"], cpu["scales"],
                        cpu["centroids"], cpu["cells"], cpu["codes2"],
                        cpu["scales2"])
        return x.double().reshape(rows.shape + (-1,))

    same, _, rel, share = _hold_to_cpu(torch, got_idx, got_d, i_cpu, d_cpu,
                                       tpp, recon, "SQ8")
    return same, rel, share


def _sq8_search_cost(torch, pipe, tpp, excl):
    """(call ms of one SQ8 search on the CUDA-event clock, each call
    ended by a synchronize as the caller reads its result; device ms of
    the kernels and copies it runs, ``timed_ms``)."""
    def search():
        with torch.inference_mode():
            pipe._retrieve(tpp, excl, "self")

    def call():
        search()
        torch.cuda.synchronize()

    return time_ms(torch, call, 10), timed_ms(torch, search)[0]


def _sq8_held_text(held) -> str:
    same, rel, share = held
    return (f"ids identical on {same} (the rest swap neighbors tied within "
            f"f32 rounding); largest relative distance error {rel:.3e}; "
            f"largest gap {share:.3f} of its bound")


def _sq8_only(launches, label: str, form: str) -> None:
    """The path launched exact_dot on int8 rows alone, in ``form`` alone,
    and extract_candidates at T = 8, m = 5 alone; no opt-in kernel."""
    _exact_dot_form_only(launches, label, form)
    if launches["exact_dot_int8"] != launches["exact_dot"]:
        raise AssertionError(f"{label}: exact_dot ran on other than int8 "
                             f"rows: {launches}")
    sel = launches["extract_candidates"]
    if sel <= 0 or launches.get("extract_candidates_T=8 m=5") != sel:
        raise AssertionError(f"{label}: extract_candidates ran other than "
                             f"at T = 8, m = 5 alone: {launches}")
    if launches["fused_mha"] + launches["fused_mha_bf16"] \
            or launches["flat_topk"]:
        raise AssertionError(f"{label}: an opt-in kernel ran: {launches}")


def _sq8_build(torch, dev, tmp, label, base, kw):
    """An SQ8 DetectionPipeline at the shipped defaults on ``base``'s
    encoder and embedding cache whose index holds ``base``'s f32 table
    (25,600 rows) in one add; saved and loaded back (arrays equal). Prints
    the build, save and load times and the device bytes."""
    from radad_tpu_torch.config import Config
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    root = os.path.join(tmp, label)
    cfg = Config().replace(
        data_root=root, vector_db_path=os.path.join(root, "vdb"),
        train_data_path=os.path.join(root, "clips"), random_seed=SEED,
        num_epochs=1, vector_db_index_type="SQ8", **kw)
    sq = DetectionPipeline(cfg, encoder=base.encoder, device=dev)
    sq._embedding_cache = base._embedding_cache
    flat = base.index
    n = flat.ntotal
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sq.index.add(flat.vectors[:n], flat.labels[:n].tolist(),
                 list(flat.paths), metadata=list(flat.metadata),
                 ids=flat.ids[:n].tolist())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built = sq.index
    names = [n_ for n_ in ("codes", "scales", "norm_sq", "labels", "ids",
                           "centroids", "cells", "codes2", "scales2")
             if getattr(built, n_) is not None]
    nbytes = sum(getattr(built, n_).numel() * getattr(built, n_)
                 .element_size() for n_ in names)
    t0 = time.perf_counter()
    built.save(cfg.vector_db_path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not sq.load_vector_database():
        raise AssertionError(f"{label}: the saved SQ8 DB did not load")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for n_ in names:
        if not torch.equal(getattr(sq.index, n_), getattr(built, n_)):
            raise AssertionError(f"{label}: {n_} differs after save -> load")
    ix = sq.index
    print(f"{label}: SQ8 index {ix.ntotal} x {ix.dimension} (residual_nlist "
          f"{ix.residual_nlist}, refine_bits {ix.refine_bits}), capacity "
          f"{ix.codes.shape[0]}: add (host quantization, k-means, norms, "
          f"upload) {build_s:.2f} s, save {save_s:.2f} s, load {load_s:.2f} "
          f"s; device bytes {nbytes} ({nbytes / 2**20:.1f} MiB; the f32 "
          f"table {n * ix.dimension * 4 / 2**20:.1f} MiB)")
    return sq


def sq8_phase(torch, dev, tmp: str, base, ref):
    """The SQ8 index at full width on the wav2vec2 serving phase's table
    (``base``: its pipeline, 25,600 x 5,376 rows, embedded clips plus
    seeded rows; ``ref``: its clips and f32 results), in three variants:
    plain, residual (nlist 1,024) and int4-refined. Each is built, saved
    and loaded (``_sq8_build``), then serves ``_counted_run``'s calls
    (predict, predict_batch at 8 and 64, self exclusion; path "<variant>"),
    trains one epoch and evaluates at the shipped defaults (B = 128 / 256;
    path "<variant>_train"), and runs ``_step_times``. Every search is
    held to the CPU (``_sq8_hold``); recall@5 against the f32 certified
    neighbors and the stage times beside the f32 path's are printed.
    Returns {path: launches}."""
    import numpy as np

    from radad_tpu_torch.data.manifest import file_id
    from radad_tpu_torch.index.quantized import quantize_rows
    from radad_tpu_torch.ops.attention import fused_mha
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates, flat_topk

    os.environ.pop("RADAD_FUSED_ATTENTION", None)
    kernels = (gather_rows, exact_dot, extract_candidates, fused_mha,
               flat_topk)
    flat = base.index
    table = flat.vectors[: flat.ntotal].cpu().numpy()
    t0 = time.perf_counter()
    quantize_rows(table)
    print(f"SQ8 host quantization of the {table.shape[0]} x {table.shape[1]}"
          f" table (numpy, quantize_rows): {time.perf_counter() - t0:.2f} s")
    del table
    q_paths, batch64 = ref["q_paths"], ref["batch64"]
    sets = _serving_sets(q_paths, batch64)
    db_paths = ref["db_paths"]
    train_m = _manifest(db_paths, flat.labels[: len(db_paths)].tolist())
    val_m = _manifest(q_paths, ref["q_labels"])
    by_path = {}
    for label, kw in SQ8_VARIANTS:
        sq = _sq8_build(torch, dev, tmp, label, base, kw)
        cpu = _sq8_cpu(sq.index)
        lat, stages, outs, launches, _ = _counted_run(torch, sq, q_paths,
                                                      batch64, kernels)
        _sq8_only(launches, label, "split")  # B = 1, 8, 64
        _report(lat, stages, sq, launches, label)
        for name, paths in sets.items():
            tpp = _embed_paths(torch, sq, paths)
            excl = torch.as_tensor([file_id(p) for p in paths],
                                   dtype=torch.int32, device=dev)
            rows = _rows_of(torch, sq, outs[name])
            dists = torch.as_tensor([[r["distance"] for r in o["retrieved"]]
                                     for o in outs[name]])
            held = _sq8_hold(torch, sq, cpu, tpp, excl, "self", rows, dists)
            hits = [len(set(a) & set(b)) for a, b in zip(
                (o["retrieved_files"] for o in outs[name]),
                ref["files"][name])]
            k = sq.config.top_k
            st = stage_ms(torch, sq, paths)
            search_ms, busy_ms = _sq8_search_cost(torch, sq, tpp, excl)
            print(f"{label} {name}: against the CPU's plain route on all "
                  f"{len(paths)} rows, {_sq8_held_text(held)}; recall@{k} "
                  f"against the f32 certified neighbors "
                  f"{sum(hits) / (k * len(hits)):.4f}; stages (median of "
                  f"5, ms) " + ", ".join(f"{s} {v:.3f}" for s, v in
                                         st.items())
                  + "; f32 certified " + ", ".join(
                      f"{s} {v:.3f}" for s, v in ref["stages"][name].items())
                  + f"; the search alone: call {search_ms:.3f} ms (CUDA "
                  f"events, synchronized), device {busy_ms:.4f} ms "
                  f"(profiler), busy {busy_ms / search_ms:.3f}")
        by_path[label] = launches

        # training: one epoch + evaluate at B = 128 / 256, counted
        torch.cuda.synchronize()
        _reset(kernels, sq.index)
        t0 = time.perf_counter()
        sq.train(train_m, val_m)
        result = sq.evaluate(val_m)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        tl = _launch_counts(kernels, sq.index)
        rows_ = [r for r in sq.writer.rows if r["epoch"] != "eval"]
        want_steps = -(-len(train_m) // sq.config.batch_size)
        if sq.step != want_steps or not np.isfinite(
                [rows_[-1]["train_loss"], result["loss"]]).all():
            raise AssertionError(f"{label}_train: {sq.step} steps, want "
                                 f"{want_steps}; rows {rows_}, {result}")
        _sq8_only(tl, f"{label}_train", "per_query")  # B = 128, 256
        print(f"{label}_train: 1 epoch ({sq.step} steps at B = "
              f"{sq.config.batch_size}) + evaluate ({result['num_samples']} "
              f"clips at B = {sq.config.eval_batch_size}) in {secs:.2f} s, "
              f"train loss {rows_[-1]['train_loss']:.6f}, eval loss "
              f"{result['loss']:.6f}; {sq.index.searches} searches, route "
              f"{sq.index.route}; kernel launches {tl}")
        by_path[f"{label}_train"] = tl
        cfg = sq.config
        train_batch = list(sq._query_batches(train_m, cfg.batch_size,
                                             shuffle=True, seed=SEED))[-1]
        eval_batch = next(iter(sq._query_batches(val_m, cfg.eval_batch_size,
                                                 shuffle=False)))
        for what, (tpp, _, ids, _) in (("train B=128", train_batch),
                                       ("eval B=256", eval_batch)):
            _, _, d, i = sq._retrieve(tpp, ids, "batch")
            held = _sq8_hold(torch, sq, cpu, tpp, ids, "batch", i, d)
            print(f"{label}_train retrieval {what}: against the CPU's plain "
                  f"route on all {tpp.shape[0]} rows, {_sq8_held_text(held)}")
        medians, steps_per_s, busy, wall_ms = _step_times(torch, sq, train_m)
        print(f"{label}_train step at B = {cfg.batch_size}: median ms "
              f"retrieve {medians['retrieve']:.3f}, forward+backward "
              f"{medians['forward_backward']:.3f}, update "
              f"{medians['update']:.3f} (CUDA-synchronized, 12 steps); "
              f"{steps_per_s:.2f} steps/s over an epoch of train_step; "
              f"device busy {busy:.3f} of one profiled step "
              f"({wall_ms:.2f} ms)")
        del sq, cpu
        torch.cuda.empty_cache()
    return by_path


def _ivf_cpu(ix) -> dict:
    """The IVF index's arrays copied to the CPU."""
    names = ("vectors", "norms_sq", "ids", "centroids", "cells", "ivf_table",
             "ivf_overflow", "ivf_chunk_rows", "ivf_cell_chunks")
    return {n: getattr(ix, n).cpu() for n in names}


def _ivf_gather(ix, arrays, q, excl, mode, table, k, nprobe=None):
    """``ivf_gather_search`` (``table="span"``) or the chunked one on
    ``arrays`` (the index's own, or ``_ivf_cpu``'s), as ``FlatIndex``
    calls them. → (dists, rows)."""
    from radad_tpu_torch.index.ivf_gather import (ivf_gather_search,
                                                  ivf_gather_search_chunked)

    a = arrays
    np_eff = min(ix.nprobe if nprobe is None else nprobe,
                 ix.nlist_effective)
    head = (q, a["vectors"], a["norms_sq"], a["ids"], excl, a["centroids"])
    if table == "span":
        return ivf_gather_search(*head, a["ivf_table"], a["ivf_overflow"], k,
                                 nprobe=np_eff, exclude_mode=mode)
    return ivf_gather_search_chunked(
        *head, a["ivf_chunk_rows"], a["ivf_cell_chunks"], a["cells"], k,
        nprobe=np_eff, budget=ix.chunk_budget(np_eff), n_valid=ix.ntotal,
        exclude_mode=mode)[:2]


def _centroid_rounding(torch, centroids, q):
    """[B, nlist] f64: the f32 rounding bound of each query's expanded
    centroid distance |q|^2 - 2 q.c + |c|^2, from the inputs alone, as
    ``_hold_to_f64``'s: 2^-21 (|q|^2 + max |c|^2) + sqrt(D) 2^-24 (|c|^2 +
    2 sum_d |q_d c_d|)."""
    q64, c64 = q.double(), centroids.double()
    csq = c64.square().sum(-1)
    return (2.0 ** -21 * (q64.square().sum(-1)[:, None] + csq.max())
            + q.shape[-1] ** 0.5 * 2.0 ** -24
            * (csq[None, :] + 2.0 * q64.abs() @ c64.abs().t()))


def _probe_flips(torch, centroids, q, p_card, p_cpu, np_eff: int):
    """[B] bool: the queries ``q`` whose probed cells (``p_card``,
    ``p_cpu``: [B, nprobe], sorted) differ between the card and the CPU.
    Each cell that flipped must have a centroid distance within twice the
    f32 rounding (``_centroid_rounding``) of the probe's edge, else this
    raises."""
    flipped = (p_card != p_cpu).any(-1)
    for r in flipped.nonzero()[:, 0].tolist():
        qr = q[r:r + 1].double()
        c64 = (qr - centroids.double()).square().sum(-1)  # [nlist]
        tol_c = _centroid_rounding(torch, centroids, q[r:r + 1])[0]
        edge = c64.sort().values[np_eff - 1]
        for c in set(p_card[r].tolist()) ^ set(p_cpu[r].tolist()):
            if float((c64[c] - edge).abs()) > 2.0 * float(tol_c[c]
                                                          + tol_c.max()):
                raise AssertionError(
                    f"IVF: row {r}'s probe flipped cell {c} on the card "
                    f"beyond the f32 rounding of its centroid distance")
    return flipped


def _ivf_hold(torch, ix, cpu, q, excl, mode, got_idx, got_d, table,
              nprobe=None):
    """A gather-route search on the card (rows ``got_idx``, distances
    ``got_d``) against the same search run on the CPU with the plain path
    on the same queries ``q`` and index arrays (``cpu``). Each query's
    probed cells must be the same on both, except where the centroid
    distances that decide a flipped probe lie within twice their f32
    rounding of each other (``_centroid_rounding``); such rows are counted
    and their neighbors not compared. On the others, ids must be
    identical except for neighbors whose f64 distances agree rank by rank
    within the score's f32 rounding (``_hold_to_f64``'s bound), and the
    distances must agree within 1e-5 relative plus that bound. → (rows
    with identical ids, rows whose probe flipped, the largest relative
    distance error, the largest share of its bound that a gap took)."""
    from radad_tpu_torch.index.flat import probe_cells

    k = got_idx.shape[1]
    np_eff = min(ix.nprobe if nprobe is None else nprobe,
                 ix.nlist_effective)
    d_cpu, i_cpu = _ivf_gather(ix, cpu, q.float().cpu(), excl.cpu(), mode,
                               table, k, nprobe)
    qd = q.float()
    p_card = probe_cells(qd, ix.centroids, np_eff).sort(-1).values
    p_cpu = probe_cells(qd.cpu(), cpu["centroids"], np_eff).sort(
        -1).values.to(q.device)
    keep = ~_probe_flips(torch, ix.centroids, qd, p_card, p_cpu, np_eff)
    got = got_idx.to(q.device).long()[keep]
    want = i_cpu.to(q.device).long()[keep]
    ok = want >= 0
    if not torch.equal(got >= 0, ok):
        raise AssertionError("IVF: the card and the CPU return different "
                             "numbers of neighbors")
    qk = qd[keep]
    rows = torch.cat([got, want], 1).clamp_min(0)
    tol = (2.0 ** -21 * (qk.double().square().sum(-1)
                         + ix.norms_sq[: ix.n].max().double())
           + 2.0 * _dot_rounding(torch, ix, qk, rows))  # [B']
    gd = got_d.to(q.device).double()[keep]
    wd = d_cpu.to(q.device).double()[keep]
    err = (gd - wd).abs().masked_fill(~ok, 0.0)
    if not bool((err <= 1e-5 * wd.abs().masked_fill(~ok, 0.0)
                 + tol[:, None]).all()):
        raise AssertionError(f"IVF: distances on the card differ from the "
                             f"CPU's beyond 1e-5 relative: {float(err.max())}")
    rel = float((err / wd.abs().masked_fill(~ok, 1.0)).max()) if len(err) \
        else 0.0

    def f64(r):
        x = ix.vectors[r.clamp_min(0)].double()
        return (x - qk.double()[:, None]).square().sum(-1).masked_fill(
            ~ok, 0.0)

    gap = (f64(got).sort(-1).values - f64(want).sort(-1).values).abs()
    gap = gap.amax(-1) if gap.numel() else gap.new_zeros((0,))
    if not bool((gap <= tol).all()):
        raise AssertionError(f"IVF: neighbors on the card differ from the "
                             f"CPU's beyond f32 rounding (excess "
                             f"{float((gap - tol).max()):.3e})")
    share = float((gap / tol).max()) if gap.numel() else 0.0
    return (int((got == want).all(-1).sum()), int((~keep).sum()), rel,
            share)


def _ivf_held_text(held) -> str:
    same, flipped, rel, share = held
    return (f"ids identical on {same} (the rest swap neighbors tied within "
            f"f32 rounding), {flipped} rows with a probe flipped within "
            f"rounding; largest relative distance error {rel:.3e}; largest "
            f"gap {share:.3f} of its bound")


def _ivf_gate(ix, b: int):
    """JAX's single-device dispatch for a predict batch of ``b`` clips
    (``radad_tpu/train/pipeline.py:660-689``): → ("gather" or "unprobed",
    2 b budget chunk)."""
    np_eff = min(ix.nprobe, ix.ivf_cell_chunks.shape[0])
    touched = 2 * b * ix.chunk_budget(np_eff) * ix.ivf_chunk_rows.shape[1]
    return ("gather" if touched < ix.ntotal else "unprobed"), touched


def _ivf_tables_text(ix) -> str:
    counts = ix.ivf_counts
    return (f"nlist_effective {ix.nlist_effective}, nprobe {ix.nprobe}, "
            f"span {ix.ivf_table.shape[1]}, overflow "
            f"{int((ix.ivf_overflow >= 0).sum())} rows, chunk "
            f"{ix.ivf_chunk_rows.shape[1]} rows x {ix.ivf_chunk_rows.shape[0]}"
            f" chunks, chunk_budget({ix.nprobe}) "
            f"{ix.chunk_budget(min(ix.nprobe, ix.nlist_effective))}, "
            f"{int((counts == 0).sum())} empty cells, largest cell "
            f"{int(counts.max())} rows, mean {ix.ntotal / len(counts):.2f}, "
            f"count-weighted mean {float((counts.astype('f8') ** 2).sum()) / ix.ntotal:.2f}")


def _ivf_bytes(torch, ix) -> int:
    names = ("vectors", "labels", "ids", "norms_sq", "scan_bf16",
             "resid_bf16", "centroids", "cells", "ivf_table", "ivf_overflow",
             "ivf_chunk_rows", "ivf_cell_chunks")
    arrays = {getattr(ix, n).data_ptr(): getattr(ix, n) for n in names
              if getattr(ix, n) is not None}  # bf16 storage: scan = rows
    return sum(a.numel() * a.element_size() for a in arrays.values())


def _ivf_build_times(torch, ix, card):
    """Times the parts of an IVF build on ``ix`` again: k-means (25 Lloyd
    steps) on its training rows, the assignment of every row, the gather
    tables; prints them and whether k-means gave the same centroids."""
    from radad_tpu_torch.index.flat import _assign_cells
    from radad_tpu_torch.index.ivf import kmeans

    n = ix.ntotal
    train = ix.vectors[: min(n, 50_000)].float()  # as _train_ivf takes it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cents, _ = kmeans(train, ix.nlist_effective, iters=ix.kmeans_iters,
                      seed=0, balance=ix.ivf_balance)
    torch.cuda.synchronize()
    km_s = time.perf_counter() - t0
    same = torch.equal(cents, ix.centroids)
    del cents
    t0 = time.perf_counter()
    for lo in range(0, n, 131_072):
        hi = min(n, lo + 131_072)
        cells = _assign_cells(ix.vectors[lo:hi], ix.centroids)
        if not torch.equal(cells, ix.cells[lo:hi]):
            raise AssertionError("IVF: the assignment differs on a rerun")
    torch.cuda.synchronize()
    as_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ix._build_gather_tables()
    torch.cuda.synchronize()
    tb_s = time.perf_counter() - t0
    flops = 2 * 2 * train.shape[0] * ix.nlist_effective * ix.dimension
    print(f"IVF build parts on {n} x {ix.dimension} ({card}): k-means "
          f"({ix.kmeans_iters} Lloyd steps on {train.shape[0]} rows, nlist "
          f"{ix.nlist_effective}; two {flops / 2e12:.3f} TFLOP f32 products "
          f"a step, TF32 off) {km_s:.3f} s "
          f"({flops * ix.kmeans_iters / km_s / 1e12:.1f} TFLOP/s), same "
          f"centroids on a rerun: {same}; assignment of every row "
          f"{as_s:.3f} s; gather tables (host numpy) {tb_s:.3f} s")


def ivf_phase(torch, dev, tmp: str, base, ref, card):
    """The IVF index at full width on the wav2vec2 serving phase's table
    (``base``: 25,600 x 5,376 rows; ``ref``: its clips and f32 results) at
    the shipped defaults (nlist 4,096, nprobe 32, balance 0, retrain on
    add). Build (its parts timed by ``_ivf_build_times``), save and load;
    serving (path "ivf": ``_counted_run``'s calls, each call kind's route
    against JAX's gate, gather-route results held to the CPU by
    ``_ivf_hold``, unprobed ones to the f64 scan, recall@5 against the f32
    certified neighbors); ``FlatIndex.search`` with ``gather=False`` at
    nprobe 8 / 32 / 128 (path "ivf_masked", held to an f64 scan of the
    probed rows); both gather searches forced at B = 1 and 8; a
    ``use_pallas`` index (no ``flat_topk``); 1 epoch + evaluate (path
    "ivf_train"). Returns {path: launches}."""
    import numpy as np

    from radad_tpu_torch.config import Config
    from radad_tpu_torch.data.manifest import file_id
    from radad_tpu_torch.index.flat import FlatIndex, probe_cells, probe_mask
    from radad_tpu_torch.ops.attention import fused_mha
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates, flat_topk
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    os.environ.pop("RADAD_FUSED_ATTENTION", None)
    kernels = (gather_rows, exact_dot, extract_candidates, fused_mha,
               flat_topk)
    root = os.path.join(tmp, "ivf")
    cfg = Config().replace(
        data_root=root, vector_db_path=os.path.join(root, "vdb"),
        train_data_path=os.path.join(root, "clips"), random_seed=SEED,
        num_epochs=1, vector_db_index_type="IVF")
    pipe = DetectionPipeline(cfg, encoder=base.encoder, device=dev)
    pipe._embedding_cache = base._embedding_cache
    flat = base.index
    n = flat.ntotal
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.index.add(flat.vectors[:n], flat.labels[:n].tolist(),
                   list(flat.paths), metadata=list(flat.metadata),
                   ids=flat.ids[:n].tolist())
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    built = pipe.index
    print(f"ivf: IVF index {n} x {built.dimension} in one add (k-means, "
          f"assignment, tables) {add_s:.2f} s ({card}); "
          f"{_ivf_tables_text(built)}")
    _ivf_build_times(torch, built, card)
    t0 = time.perf_counter()
    built.save(cfg.vector_db_path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not pipe.load_vector_database():
        raise AssertionError("ivf: the saved IVF DB did not load")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ix = pipe.index
    for name in ("vectors", "ids", "centroids", "ivf_table", "ivf_overflow",
                 "ivf_chunk_rows", "ivf_cell_chunks"):
        if not torch.equal(getattr(ix, name), getattr(built, name)):
            raise AssertionError(f"ivf: {name} differs after save -> load")
    if not torch.equal(ix.cells[:n], built.cells[:n]):
        raise AssertionError("ivf: cells differ after save -> load")
    nbytes = _ivf_bytes(torch, ix)
    print(f"ivf: save {save_s:.2f} s, load (no k-means) {load_s:.2f} s; "
          f"device bytes {nbytes} ({nbytes / 2**20:.1f} MiB; of it the "
          f"quantizer and tables "
          f"{(nbytes - _ivf_bytes(torch, flat)) / 2**20:.1f} MiB)")
    del built
    cpu = _ivf_cpu(ix)
    k = cfg.top_k
    q_paths, batch64 = ref["q_paths"], ref["batch64"]
    sets = _serving_sets(q_paths, batch64)
    by_path = {}

    # serving: the counted run, then each call kind's route
    lat, stages, outs, launches, _ = _counted_run(torch, pipe, q_paths,
                                                  batch64, kernels)
    if launches["gather_searches"] <= 0:
        raise AssertionError(f"ivf: no serving call took the gather route: "
                             f"{launches}")
    for name in ("gather_rows", "exact_dot", "extract_candidates"):
        if launches[name] <= 0:
            raise AssertionError(f"ivf: {name} not launched by the unprobed "
                                 f"calls: {launches}")
    _exact_dot_form_only(launches, "ivf", "split")
    if launches["flat_topk"] or launches["fused_mha"] \
            or launches["fused_mha_bf16"]:
        raise AssertionError(f"ivf: an opt-in kernel ran: {launches}")
    _report(lat, stages, pipe, launches, "ivf")
    by_path["ivf"] = launches
    for name, paths in sets.items():
        want, touched = _ivf_gate(ix, len(paths))
        _reset(kernels, ix)
        if name == "predict_1":
            outs[name] = [pipe.predict(paths[0])]
        else:
            outs[name] = pipe.predict_batch(paths)
        torch.cuda.synchronize()
        took = ("gather" if ix.ivf_gather_searches and not ix.searches
                else "unprobed" if ix.searches and not ix.ivf_gather_searches
                else f"{ix.ivf_gather_searches} gather + {ix.searches} "
                     f"unprobed")
        if took != want:
            raise AssertionError(f"ivf {name}: took the {took} route, JAX's "
                                 f"gate picks {want}")
        tpp = _embed_paths(torch, pipe, paths)
        excl = torch.as_tensor([file_id(p) for p in paths],
                               dtype=torch.int32, device=dev)
        if took == "gather":
            rows = _rows_of(torch, pipe, outs[name])
            dists = torch.as_tensor([[r["distance"] for r in o["retrieved"]]
                                     for o in outs[name]])
            mode = "batch" if name == "predict_1" else "self"
            held = _ivf_held_text(_ivf_hold(torch, ix, cpu, tpp, excl, mode,
                                            rows, dists, "chunked"))
            held = f"against the CPU's plain route: {held}"
        else:
            held = ("against the f64 full scan: "
                    + _held_text(_check_against_full_scan(
                        torch, pipe, paths, outs[name])))
        hits = [len(set(a) & set(b)) for a, b in zip(
            (o["retrieved_files"] for o in outs[name]), ref["files"][name])]
        st = stage_ms(torch, pipe, paths)
        print(f"ivf {name}: route {took} (JAX's gate: 2 B budget chunk = "
              f"{touched} against n = {ix.ntotal}), {len(paths)} rows held "
              f"{held}; recall@{k} against the f32 certified neighbors "
              f"{sum(hits) / (k * len(hits)):.4f}; stages (median of 5, ms) "
              + ", ".join(f"{s} {v:.3f}" for s, v in st.items())
              + "; f32 certified " + ", ".join(
                  f"{s} {v:.3f}" for s, v in ref["stages"][name].items()))
        if took == "gather":
            mode = "batch" if name == "predict_1" else "self"

            def search():
                with torch.inference_mode():
                    pipe._retrieve(tpp, excl, mode, prefer_ivf_gather=True)

            def call():
                search()
                torch.cuda.synchronize()

            call_ms, dev_ms = time_ms(torch, call, 10), timed_ms(
                torch, search)[0]
            print(f"ivf {name}: the gather route alone: call {call_ms:.4f} ms"
                  f" (CUDA events, synchronized), device {dev_ms:.4f} ms "
                  f"(profiler), busy {dev_ms / call_ms:.3f} ({card}); "
                  f"device ms by kernel: {_kernel_breakdown(torch, search)}")

    # FlatIndex.search's masked route at B = 64, nprobe 8 / 32 / 128
    tpp = _embed_paths(torch, pipe, batch64)
    excl = torch.as_tensor([file_id(p) for p in batch64], dtype=torch.int32,
                           device=dev)
    base_mask = _exclusion_mask(torch, ix, excl, "self")
    _reset(kernels, ix)
    results = {}
    for nprobe in IVF_MASKED_NPROBES:
        results[nprobe] = ix.search(tpp, k, exclude_ids=excl.cpu().numpy(),
                                    nprobe=nprobe, gather=False,
                                    _exclude_mode="self")
    torch.cuda.synchronize()
    masked = _launch_counts(kernels, ix)
    for name in ("exact_dot", "extract_candidates"):
        if masked[name] <= 0:
            raise AssertionError(f"ivf_masked: {name} not launched: {masked}")
    if masked["flat_topk"] or masked["gather_searches"]:
        raise AssertionError(f"ivf_masked: not the masked route: {masked}")
    by_path["ivf_masked"] = masked
    for nprobe, (_, rows) in results.items():
        got = torch.as_tensor(rows, device=dev)
        mask = base_mask | ~probe_mask(probe_cells(tpp, ix.centroids, nprobe),
                                       ix.cells, ix.nlist_effective)
        held = _hold_to_f64(torch, ix, tpp, mask, got, k)
        names = [[os.path.basename(ix.paths[r]) for r in row]
                 for row in rows.tolist()]
        hits = [len(set(a) & set(b)) for a, b in zip(
            names, ref["files"]["predict_batch_64"])]

        def search(nprobe=nprobe):
            ix.search(tpp, k, exclude_ids=excl.cpu().numpy(), nprobe=nprobe,
                      gather=False, _exclude_mode="self")

        call_ms, dev_ms = time_ms(torch, search, 10), timed_ms(
            torch, search, 10)[0]
        print(f"ivf_masked nprobe {nprobe}, B = 64: held to an f64 scan of "
              f"the probed rows, {_held_text(held)}; recall@{k} against the "
              f"f32 certified neighbors {sum(hits) / (k * len(hits)):.4f}; "
              f"call {call_ms:.4f} ms (CUDA events), device {dev_ms:.4f} ms "
              f"(profiler) ({card})")
    print(f"ivf_masked: {masked}")

    # both gather searches forced, B = 1 and 8, held to the CPU
    for b in (1, 8):
        q = _embed_paths(torch, pipe, q_paths[8:8 + b])
        ex = torch.as_tensor([file_id(p) for p in q_paths[8:8 + b]],
                             dtype=torch.int32, device=dev)
        for table in ("span", "chunked"):
            arrays = {n_: getattr(ix, n_) for n_ in cpu}
            d_, i_ = _ivf_gather(ix, arrays, q, ex, "self", table, k)
            held = _ivf_hold(torch, ix, cpu, q, ex, "self", i_, d_, table)

            def run(table=table, q=q, ex=ex, arrays=arrays):
                _ivf_gather(ix, arrays, q, ex, "self", table, k)

            print(f"ivf forced {table} gather, B = {b}: against the CPU's "
                  f"plain route, {_ivf_held_text(held)}; device "
                  f"{timed_ms(torch, run, 10)[0]:.4f} ms (profiler) ({card})")

    # use_pallas: IVF keeps the certified route
    pallas = FlatIndex.load(cfg.vector_db_path, use_pallas=True, device=dev)
    _reset(kernels, pallas)
    pallas.search(tpp, k, exclude_ids=excl.cpu().numpy(), gather=False,
                  _exclude_mode="self")
    pallas.search(tpp[:1], k, exclude_ids=excl[:1].cpu().numpy())
    torch.cuda.synchronize()
    pl = _launch_counts(kernels, pallas)
    if pl["flat_topk"] or pl["exact_dot"] <= 0 or pallas.route != "certified":
        raise AssertionError(f"ivf use_pallas: flat_topk ran or the "
                             f"certified route did not: {pl}")
    print(f"ivf use_pallas=True: route {pallas.route}, launches {pl}")
    del pallas

    # training: one epoch + evaluate at B = 128 / 256, counted
    db_paths = ref["db_paths"]
    train_m = _manifest(db_paths, flat.labels[: len(db_paths)].tolist())
    val_m = _manifest(q_paths, ref["q_labels"])
    torch.cuda.synchronize()
    _reset(kernels, ix)
    t0 = time.perf_counter()
    pipe.train(train_m, val_m)
    result = pipe.evaluate(val_m)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    tl = _launch_counts(kernels, pipe.index)
    for name in ("gather_rows", "exact_dot", "extract_candidates"):
        if tl[name] <= 0:
            raise AssertionError(f"ivf_train: {name} not launched: {tl}")
    _exact_dot_form_only(tl, "ivf_train", "per_query")  # B = 128, 256
    if tl["flat_topk"] or tl["gather_searches"]:
        raise AssertionError(f"ivf_train: not the unprobed route: {tl}")
    rows_ = [r for r in pipe.writer.rows if r["epoch"] != "eval"]
    if not np.isfinite([rows_[-1]["train_loss"], result["loss"]]).all():
        raise AssertionError(f"ivf_train: non-finite loss {rows_}")
    eval_batch = next(iter(pipe._query_batches(val_m, cfg.eval_batch_size,
                                               shuffle=False)))
    etpp, _, eids, _ = eval_batch
    got = pipe._retrieve(etpp, eids, "batch")[3]
    held = _hold_to_f64(torch, ix, etpp,
                        _exclusion_mask(torch, ix, eids, "batch"), got, k)
    print(f"ivf_train: 1 epoch ({pipe.step} steps at B = {cfg.batch_size}) "
          f"+ evaluate ({result['num_samples']} clips at B = "
          f"{cfg.eval_batch_size}) in {secs:.2f} s, train loss "
          f"{rows_[-1]['train_loss']:.6f}, eval loss {result['loss']:.6f}; "
          f"eval batch's retrieval (B = {etpp.shape[0]}, unprobed) against "
          f"the f64 full scan: {_held_text(held)}; kernel launches {tl}")
    by_path["ivf_train"] = tl
    del pipe, cpu
    torch.cuda.empty_cache()
    return by_path


def _capacity_rows(torch, g, kind: str, d: int):
    """A maker of seeded rows ``m -> [m, d]`` on ``g``'s device, of the
    IVF_CAPACITY_DATA kind ``kind``."""
    dev = g.device
    if kind == "latent":
        basis = torch.randn((64, d), generator=g, device=dev) / 8.0

        def make(m):
            z = torch.randn((m, 64), generator=g, device=dev)
            return z @ basis + 0.1 * torch.randn((m, d), generator=g,
                                                 device=dev)
        return make
    weights = torch.randn((2048,), generator=g, device=dev).exp()
    centers = 1.5 * torch.randn((2048, d), generator=g, device=dev)

    def make(m):
        comp = torch.multinomial(weights, m, replacement=True, generator=g)
        return centers[comp] + torch.randn((m, d), generator=g, device=dev)
    return make


def ivf_capacity_phase(torch, dev, card, label: str, kind: str,
                       storage: str):
    """IVF at capacity scale: ``FlatIndex(5376, "IVF")`` at nlist 4,096 and
    nprobe 32 over IVF_CAPACITY_ROWS seeded rows of the IVF_CAPACITY_DATA
    kind ``kind``, made on the device in the ``storage`` dtype and added in
    one call with ``donate=True``, which must adopt them as the stored rows
    (no copy): f32, the table and its bf16 scan and residual copies, 45 GB
    of the 80; bf16 (``use_float16=True, single_buffer=True``), one 11 GB
    buffer, ``exact_dot`` on its bf16 rows. Peak device memory of the add
    printed. Build parts timed; B = 1 / 8 / 64 on the gather route and the
    masked route (path ``label``: each route once a B, counted), call ms on
    CUDA events and device ms (profiler) with their byte bounds, the
    kernels of the gather route at B = 1; the gather route's neighbors held
    to the masked route's. → {label: launches}."""
    import numpy as np

    from radad_tpu_torch.index.flat import FlatIndex
    from radad_tpu_torch.ops.attention import fused_mha
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates, flat_topk

    kernels = (gather_rows, exact_dot, extract_candidates, fused_mha,
               flat_topk)
    n, d, k = IVF_CAPACITY_ROWS, IVF_CAPACITY_DIM, 5
    bf16 = storage == "bf16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    make = _capacity_rows(torch, g, kind, d)
    rows = torch.empty((n, d), device=dev, dtype=dtype)
    for lo in range(0, n, 65_536):
        rows[lo:lo + 65_536] = make(min(65_536, n - lo))
    queries = make(64)
    del make
    ix = FlatIndex(d, "IVF", nlist=IVF_NLIST, nprobe=IVF_NPROBE,
                   use_float16=bf16, single_buffer=bf16, device=dev)
    torch.cuda.synchronize()
    rows_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    ix.add(rows, np.zeros((n,), np.float32),
           [f"cap_{i:07d}.wav" for i in range(n)],
           ids=np.arange(n, dtype=np.int32), donate=True)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    if ix.vectors is not rows or ix.vectors.data_ptr() != rows.data_ptr():
        raise AssertionError(f"{label}: the donated rows were copied")
    del rows
    torch.cuda.empty_cache()
    print(f"{label}: {kind} rows, {n} x {d} {storage} rows "
          f"({n * d * dtype.itemsize / 1e9:.1f} GB) in one add with "
          f"donate=True, adopted as the stored rows (no copy) (k-means on "
          f"the first 50,000, assignment, tables) {add_s:.2f} s; device "
          f"memory {rows_gib:.2f} GiB before the add, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; index "
          f"bytes {_ivf_bytes(torch, ix) / 2**30:.2f} GiB ({card}); "
          f"{_ivf_tables_text(ix)}")
    _ivf_build_times(torch, ix, card)
    np_eff = min(ix.nprobe, ix.nlist_effective)
    budget, chunk = ix.chunk_budget(np_eff), ix.ivf_chunk_rows.shape[1]
    span_rows = np_eff * ix.ivf_table.shape[1] + ix.ivf_overflow.shape[0]
    _reset(kernels, ix)
    out = {}
    for b in (1, 8, 64):
        q = queries[:b]
        out[b] = {r: ix.search(q, k, gather=(r == "gather"))
                  for r in ("gather", "masked")}
    torch.cuda.synchronize()
    launches = _launch_counts(kernels, ix)
    for name in ("exact_dot", "extract_candidates"):
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} not launched: "
                                 f"{launches}")
    if launches["flat_topk"] or launches["gather_searches"] != 3:
        raise AssertionError(f"{label}: routes not as asked: {launches}")
    if launches[f"exact_dot_{storage}"] != launches["exact_dot"]:
        raise AssertionError(f"{label}: exact_dot ran on other rows than "
                             f"{storage}: {launches}")
    print(f"{label}: launches {launches}")
    cent_bytes = ix.centroids.numel() * 4
    for b in (1, 8, 64):
        q = queries[:b]
        table = "chunked" if b * budget * chunk <= b * span_rows else "span"
        g_rows = b * (budget * chunk if table == "chunked" else span_rows)
        for r in ("gather", "masked"):
            def search(r=r, q=q):
                ix.search(q, k, gather=(r == "gather"))

            call_ms = time_ms(torch, search, 10)
            dev_ms = timed_ms(torch, search, 10)[0]
            if r == "gather":
                nbytes = g_rows * d * dtype.itemsize + cent_bytes
                what = (f"{table} table, {g_rows} candidate rows + the "
                        f"centroids")
            elif bf16:
                nbytes = n * d * 2  # the stored rows are the scan copy
                what = "the bf16 rows, each once"
            else:
                nbytes = n * d * 2 * 2  # the bf16 scan copy and residual
                what = "the bf16 scan copy and residual of every row"
            bnd = bound_ms(nbytes)[0]
            if r == "gather" and b == 1:
                print(f"{label} gather B = 1, device ms by kernel: "
                      f"{_kernel_breakdown(torch, search)}")
            print(f"{label} {r} B = {b}: call {call_ms:.4f} ms (CUDA "
                  f"events), device {dev_ms:.4f} ms (profiler); byte bound "
                  f"{bnd:.4f} ms ({what}: {nbytes / 1e9:.3f} GB at 3.35 "
                  f"TB/s) ({card})")
        (gd, gi), (md, mi) = out[b]["gather"], out[b]["masked"]
        gi_t, mi_t = (torch.as_tensor(a, device=dev) for a in (gi, mi))
        qd = q.double()

        def f64(r_):
            return (ix.vectors[r_.clamp_min(0)].double() - qd[:, None]
                    ).square().sum(-1)

        tol = (2.0 ** -21 * (qd.square().sum(-1)
                             + ix.norms_sq[:n].max().double())
               + 2.0 * _dot_rounding(torch, ix, q,
                                     torch.cat([gi_t, mi_t], 1)))
        gap = f64(gi_t).sort(-1).values - f64(mi_t).sort(-1).values
        # the gather set holds the masked set (the chunk table: equals it)
        worse = gap.amax(-1) if table == "span" else gap.abs().amax(-1)
        if not bool((worse <= tol).all()):
            raise AssertionError(f"{label} B = {b}: the gather route's "
                                 f"neighbors differ from the masked route's "
                                 f"beyond f32 rounding")
        print(f"{label} B = {b}: gather ids identical to the masked "
              f"route's on {int((gi_t == mi_t).all(-1).sum())} of {b} rows "
              f"(the rest within f32 rounding), largest gap "
              f"{float((worse / tol).max()):.3f} of its bound")
    del ix, queries
    torch.cuda.empty_cache()
    return {label: launches}


def server_phase(pipe, q_paths) -> None:
    """The port's HTTP server on localhost: 3 WAV uploads to /api/predict."""
    import threading
    import urllib.request

    from radad_tpu_torch.serve.app import serve

    httpd = serve(pipe.config, host="127.0.0.1", port=0, pipeline=pipe)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        for path in q_paths[40:43]:
            with open(path, "rb") as f:
                wav = f.read()
            boundary = "radadsmokeboundary"
            body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                    f"name=\"file\"; filename=\"{os.path.basename(path)}\""
                    f"\r\nContent-Type: audio/wav\r\n\r\n").encode() \
                + wav + f"\r\n--{boundary}--\r\n".encode()
            req = urllib.request.Request(
                base + "/api/predict", data=body, method="POST",
                headers={"Content-Type":
                         f"multipart/form-data; boundary={boundary}"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as resp:
                status = resp.status
                out = json.loads(resp.read())
            ms = (time.perf_counter() - t) * 1e3
            if status != 200 or not out.get("ok"):
                raise AssertionError(f"/api/predict answered {status}: {out}")
            missing = {"prediction", "probability", "probability_spoof",
                       "neighbors", "timings_ms"} - set(out)
            if missing or len(out["neighbors"]) != pipe.config.top_k:
                raise AssertionError(f"/api/predict payload lacks {missing}")
            print(f"server: POST /api/predict {status} in {ms:.2f} ms, "
                  f"prediction {out['prediction']}, timings_ms "
                  f"{out['timings_ms']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")


# the card's bf16 update against the CPU's bf16 update (the first update,
# from a fresh optimizer state): bf16 activations and gradients whose f32
# sums round apart (cuBLAS against the CPU's GEMM) move a bf16 rounding here
# and there, forward and backward. Loss, grad norms and BatchNorm
# statistics as the port's bf16 steps against JAX's
# (tests/test_torch_mixed_precision.py); logits within 4 bf16 steps at 1;
# moments within 0.1 of their group's largest (a chip run read 0.057). The
# first Adam step moves a coordinate by lr times the sign of its gradient,
# so where the bf16 gradient is rounding (biases ahead of a norm, exact
# gradient 0) the two sides step apart by 2 lr: at most 15 % of the
# coordinates (a chip run read 7.5 %), each within 2 lr.
BF16_UPDATE_LIMITS = dict(loss=2e-3, logits=2.0 ** -5, grad_norms=1e-2,
                          bn_stats=1e-2, moments=0.1, near_zero_share=0.15)


def _update_on_cpu(torch, pipe, batch, neighbors, limits=None):
    """The card's update against the same update on the CPU, both with the
    port's own code and dropout 0: a copy of the trained model and its
    optimizer state, one batch (B = 128, pad rows included) and the
    neighbors the card retrieved for it. Tolerances (f32 on both sides,
    sums in other orders, TF32 off on the card): loss within 1e-5 relative,
    logits within 1e-4 (1 + |logit|), per-group gradient norms within 1e-4
    relative, BatchNorm running statistics within 1e-5 (1 + |x|), Adam's
    moments within 1e-4 of their group's largest value; parameters within
    1e-6 + 1e-5 |p|, except where the two first moments disagree by more
    than 0.1 % (Adam's input within rounding of 0, where its step may go
    up to lr either way): at most 0.5 % of the coordinates, each within
    2 lr. ``limits`` overrides any of these (BF16_UPDATE_LIMITS for the
    mixed-precision model). → the largest errors seen."""
    import copy

    from radad_tpu_torch.models.fusion import Dropout
    from radad_tpu_torch.train.optim import GroupAdam
    from radad_tpu_torch.train.pipeline import (make_step_fns,
                                                new_accumulators)

    tpp, labels, _, valid = batch
    pw = 1.25
    out = {}
    for side, dev in (("card", pipe.device), ("cpu", torch.device("cpu"))):
        model = copy.deepcopy(pipe.model).to(dev)
        for drop in model.modules():
            if isinstance(drop, Dropout):
                drop.p = 0.0
        opt = GroupAdam(pipe.opt.lr, pipe.opt.wd)
        opt.load_state_dict(pipe.opt.state, device=dev)
        steps = make_step_fns(model, opt, None)
        args = [x.to(dev) for x in (neighbors, tpp, labels, valid)]
        loss, logits, grads = steps.forward_backward(*args, pw)
        bm = steps.apply(new_accumulators(dev), args[0], args[2], args[3],
                         loss, logits, grads)
        out[side] = dict(
            loss=float(loss), logits=logits.cpu(),
            gn={k: float(bm[k]) for k in ("gn_proj", "gn_fuse", "gn_det")},
            state={k: v.cpu() for k, v in model.state_dict().items()},
            opt={g: {key: {n: t.cpu() for n, t in st[key].items()}
                     for key in ("mu", "nu")}
                 for g, st in opt.state.items()})
    card, cpu = out["card"], out["cpu"]
    errs = dict(loss=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]))
    errs["logits"] = float(((card["logits"] - cpu["logits"]).abs()
                            / (1 + cpu["logits"].abs())).max())
    errs["grad_norms"] = max(abs(card["gn"][k] - cpu["gn"][k]) / cpu["gn"][k]
                             for k in cpu["gn"])
    errs["bn_stats"] = max(
        float(((card["state"][k] - v).abs() / (1 + v.abs())).max())
        for k, v in cpu["state"].items() if "running" in k)
    errs["moments"], mu_off = 0.0, {}
    for g, st in cpu["opt"].items():
        for key in ("mu", "nu"):
            scale = max(float(t.abs().max()) for t in st[key].values())
            for n, want in st[key].items():
                diff = (card["opt"][g][key][n] - want).abs()
                errs["moments"] = max(errs["moments"],
                                      float(diff.max()) / scale)
                if key == "mu":
                    mu_off[n] = diff > 1e-3 * want.abs()
    off = total = 0
    errs["params"] = errs["params_near_zero"] = 0.0
    for n, want in cpu["state"].items():
        if n not in mu_off:
            continue
        diff = (card["state"][n] - want).abs()
        ratio = diff / (1e-6 + 1e-5 * want.abs())
        for key, vals, sel in (("params", ratio, ~mu_off[n]),
                               ("params_near_zero", diff, mu_off[n])):
            if bool(sel.any()):
                errs[key] = max(errs[key], float(vals[sel].max()))
        off += int((ratio > 1).sum())
        total += diff.numel()
    errs["near_zero_share"] = off / total
    # params: |diff| / (1e-6 + 1e-5 |p|); params_near_zero: |diff| on the
    # near-zero coordinates
    limits = dict(dict(loss=1e-5, logits=1e-4, grad_norms=1e-4,
                       bn_stats=1e-5, moments=1e-4, params=1.0,
                       near_zero_share=0.005,
                       params_near_zero=2 * pipe.opt.lr + 1e-6),
                  **(limits or {}))
    over = {k: v for k, v in errs.items() if v > limits[k]}
    if over:
        raise AssertionError(f"update check: the card's update differs from "
                             f"the CPU's: {over} (limits {limits})")
    return errs


def _step_times(torch, pipe, train_m, n_steps: int = 12):
    """Median ms of one train step's retrieve, forward+backward and update
    (optimizer + BatchNorm statistics), each ended by a CUDA synchronize,
    over ``n_steps`` steps after one warm-up; steps/s of one epoch of
    ``train_step`` calls; the device busy share of one profiled step (the
    profiler's CUDA time over the step's wall time). It trains ``pipe``
    further."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from radad_tpu_torch.train.pipeline import new_accumulators

    steps = pipe._steps()
    pw = train_m.pos_weight()
    batches = list(pipe._query_batches(train_m, pipe.config.batch_size,
                                       shuffle=True, seed=SEED + 99))
    acc = new_accumulators(pipe.device)
    split = {"retrieve": [], "forward_backward": [], "update": []}
    for i in range(n_steps + 1):
        tpp, labels, ids, valid = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        neighbors, _ = steps.fetch(tpp, ids)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, logits, grads = steps.forward_backward(
            neighbors, tpp, labels, valid, pw, pipe.generator)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        steps.apply(acc, neighbors, labels, valid, loss, logits, grads)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i:
            for key, a, b in (("retrieve", t0, t1),
                              ("forward_backward", t1, t2),
                              ("update", t2, t3)):
                split[key].append((b - a) * 1e3)
    medians = {k: statistics.median(v) for k, v in split.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tpp, labels, ids, valid in batches:
        steps.train_step(acc, tpp, labels, ids, valid, pw, pipe.generator)
    torch.cuda.synchronize()
    steps_per_s = len(batches) / (time.perf_counter() - t0)
    tpp, labels, ids, valid = batches[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.train_step(acc, tpp, labels, ids, valid, pw, pipe.generator)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.device_time_total for e in prof.key_averages()
                  if getattr(getattr(e, "device_type", None), "name", "")
                  == "CUDA") / 1e3
    return medians, steps_per_s, busy_ms / wall_ms, wall_ms


def _resumed(torch, pipe, cfg, dev):
    """A fresh pipeline of ``cfg`` on ``pipe``'s encoder, index and
    embedding cache that loaded ``pipe``'s saved final checkpoint; raises
    unless its step, optimizer state (count, both moments) and f32
    parameters equal ``pipe``'s."""
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    pipe.save_models("final_model")
    fresh = DetectionPipeline(cfg, encoder=pipe.encoder, device=dev)
    fresh.index = pipe.index
    fresh._embedding_cache = pipe._embedding_cache
    if not fresh.load_models("final_model") or fresh.step != pipe.step:
        raise AssertionError("resume: checkpoint not loaded at its step")
    for g, st in pipe.opt.state.items():
        got = fresh.opt.state[g]
        same = torch.equal(st["count"], got["count"]) and all(
            torch.equal(st[k][n], got[k][n])
            for k in ("mu", "nu") for n in st[k])
        if not same:
            raise AssertionError(f"resume: optimizer state of {g} differs")
    params = dict(pipe.model.named_parameters())
    for n, p in fresh.model.named_parameters():
        if p.dtype != torch.float32 or not torch.equal(p, params[n]):
            raise AssertionError(f"resume: parameter {n} differs")
    return fresh


def train_phase(torch, dev, tmp: str):
    """The trainer at the shipped defaults (wav2vec2-base-960h, f32, seeded
    random weights, TPP (1, 2, 4) max → D = 5,376, L2 top-5, the BatchNorm
    head with dropout 0.1, batch 128, eval batch 256, lr 1e-3, wd 1e-5,
    cached embeddings): 500 train and 300 val clips (a partial last batch
    in both), the DB built from the train clips and padded to INDEX_ROWS,
    ``train`` for 3 epochs and ``evaluate``, counted on path "train"; the
    step's retrieval at B = 128 (batch exclusion) and 256 against the f64
    scan; the update against the CPU's; save, load into a fresh pipeline
    (equal optimizer state and step) and one more epoch; step timings.
    Returns ({path: launches}, the resumed pipeline)."""
    import numpy as np

    from radad_tpu_torch.config import Config
    from radad_tpu_torch.ops.attention import fused_mha
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates, flat_topk
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    os.environ.pop("RADAD_FUSED_ATTENTION", None)
    root = os.path.join(tmp, "train")
    cfg = Config().replace(
        data_root=root, vector_db_path=os.path.join(root, "vdb"),
        train_data_path=os.path.join(root, "clips"), random_seed=SEED,
        num_epochs=3)
    os.makedirs(cfg.train_data_path)
    train_m = _manifest(*_write_clips(cfg.train_data_path, TRAIN_CLIPS,
                                      SEED + 5, "train"))
    val_m = _manifest(*_write_clips(cfg.train_data_path, VAL_CLIPS, SEED + 6,
                                    "val"))
    pipe = DetectionPipeline(cfg, device=dev)
    enc = pipe.encoder.arch_cfg
    print(f"train phase: {pipe.encoder.name} {enc.num_hidden_layers} layers "
          f"x {enc.hidden_size} wide, pretrained={pipe.encoder.pretrained}, "
          f"BatchNorm head={cfg.use_batch_norm}, dropout "
          f"{cfg.projection_dropout}/{cfg.detection_dropout}, batch "
          f"{cfg.batch_size}, eval batch {cfg.eval_batch_size}, lr "
          f"{cfg.learning_rate}, wd {cfg.weight_decay}, "
          f"{len(train_m)} train / {len(val_m)} val clips")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.build_vector_database(train_m, save=False)
    torch.cuda.synchronize()
    print(f"train phase: build_vector_database {len(train_m)} clips in "
          f"{time.perf_counter() - t0:.2f} s")
    _pad_index(torch, pipe, INDEX_ROWS, SEED + 7)
    ix = pipe.index
    kernels = (gather_rows, exact_dot, extract_candidates, fused_mha,
               flat_topk)
    torch.cuda.synchronize()
    _reset(kernels, ix)
    t0 = time.perf_counter()
    pipe.train(train_m, val_m)
    result = pipe.evaluate(val_m)
    torch.cuda.synchronize()
    launches = _launch_counts(kernels, ix)
    secs = time.perf_counter() - t0
    epochs = [r for r in pipe.writer.rows if r["epoch"] != "eval"]
    for r in epochs:
        print(f"train epoch {r['epoch']}: train loss {r['train_loss']:.6f}, "
              f"val loss {r['val_loss']:.6f}, EER {r['eer_percent']:.4f} %, "
              f"epoch {r['epoch_time_sec']:.3f} s (validation included)")
    print(f"train phase: evaluate(val) loss {result['loss']:.6f}, EER "
          f"{result['eer_percent']:.4f} %, {result['num_samples']} clips; "
          f"train + evaluate {secs:.2f} s, {pipe.step} steps, "
          f"{ix.searches} searches, {ix.fallbacks} fallbacks to the full "
          f"f32 scan; kernel launches {launches}")
    want_steps = cfg.num_epochs * -(-len(train_m) // cfg.batch_size)
    if len(epochs) != cfg.num_epochs or pipe.step != want_steps:
        raise AssertionError(f"train ran {len(epochs)} epochs and "
                             f"{pipe.step} steps, want {cfg.num_epochs} and "
                             f"{want_steps}")
    if not all(np.isfinite([r["train_loss"], r["val_loss"]]).all()
               for r in epochs) or not np.isfinite(result["loss"]):
        raise AssertionError("non-finite loss in training")
    for name in ("gather_rows", "exact_dot", "extract_candidates"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"training path")
    if launches["fused_mha"] or launches["flat_topk"]:
        raise AssertionError(f"the training path launched an opt-in kernel: "
                             f"{launches}")
    _exact_dot_form_only(launches, "train", "per_query")  # B = 128, 256

    # the step's own retrieval against the f64 scan: a train batch (batch
    # exclusion, the last one with its pad rows) and an eval batch
    steps = pipe._steps()
    train_batch = list(pipe._query_batches(train_m, cfg.batch_size,
                                           shuffle=True, seed=SEED))[-1]
    eval_batch = next(iter(pipe._query_batches(val_m, cfg.eval_batch_size,
                                               shuffle=False)))
    for what, (tpp, _, ids, _) in (("train B=128", train_batch),
                                   ("eval B=256", eval_batch)):
        _, _, _, idx = pipe._retrieve(tpp, ids, "batch")
        held = _hold_to_f64(
            torch, ix, tpp, _exclusion_mask(torch, ix, ids, "batch"), idx,
            cfg.top_k)
        print(f"train phase retrieval {what}: neighbors match the f64 full "
              f"scan on all {tpp.shape[0]} rows, {_held_text(held)}")

    neighbors, _ = steps.fetch(train_batch[0], train_batch[2])
    errs = _update_on_cpu(torch, pipe, train_batch, neighbors)
    print("train phase update, card against CPU (dropout 0): " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + " (loss, grad norms: "
        "relative; logits: of 1 + |logit|; bn_stats: of 1 + |x|; moments: "
        "of the group's largest; params: largest |diff| / (1e-6 + 1e-5 |p|) "
        "off the near-zero coordinates; params_near_zero: largest |diff| on "
        "them; near_zero_share: coordinates beyond 1e-6 + 1e-5 |p|)")

    # resume: the checkpoint into a fresh pipeline, then one more epoch
    fresh = _resumed(torch, pipe, cfg.replace(num_epochs=1), dev)
    fresh.train(train_m, val_m)
    row = fresh.writer.rows[-1]
    if fresh.step != pipe.step + want_steps // cfg.num_epochs or not (
            np.isfinite(row["train_loss"])):
        raise AssertionError(f"resume: step {fresh.step} after one more "
                             f"epoch, row {row}")
    print(f"train phase resume: optimizer state and step {pipe.step} equal "
          f"after load_models; one more epoch to step {fresh.step}, train "
          f"loss {row['train_loss']:.6f}, val loss {row['val_loss']:.6f}")

    medians, steps_per_s, busy, wall_ms = _step_times(torch, fresh, train_m)
    print(f"train step at B = {cfg.batch_size}: median ms retrieve "
          f"{medians['retrieve']:.3f}, forward+backward "
          f"{medians['forward_backward']:.3f}, update "
          f"{medians['update']:.3f} (CUDA-synchronized, 12 steps); "
          f"{steps_per_s:.2f} steps/s over an epoch of train_step; device "
          f"busy {busy:.3f} of one profiled step ({wall_ms:.2f} ms)")
    del pipe
    return {"train": launches}, fresh


def _train_then_introspect(torch, dev, tmp: str, card: str):
    """``train_phase``, then ``introspect_phase`` on its trained pipeline.
    → {path: launches}."""
    paths, pipe = train_phase(torch, dev, tmp)
    paths.update(introspect_phase(torch, dev, tmp, pipe, card))
    return paths


# the keys of radad_tpu/models/introspect.py::activations (flax's
# capture_intermediates) for the shipped head: BatchNorm, dropout 0.1
ACTIVATION_KEYS = tuple(
    [f"projection_layer/{m}/__call__" for m in (
        "attention_score", "attention_final", "cst_hidden", "cst_output",
        "weight_sum", "normalization", "Dropout_0", "unified_embedding")]
    + ["projection_layer/__call__", "fuse/__call__"]
    + [f"detection_model/{m}_{i}/__call__" for i in (0, 1)
       for m in ("linear", "norm", "Dropout")]
    + ["detection_model/linear_2/__call__", "detection_model/__call__",
       "__call__"])


def _fusion_f64(torch, model, neighbors, tpp):
    """The fusion model's eval forward in f64 from its parameters and
    running statistics (the projection's LayerNorm, the BatchNorm head):
    the finite differences' reference. → logits [B] f64."""
    import torch.nn.functional as F

    p = {k: v.double() for k, v in model.state_dict().items()}

    def lin(name, x):
        return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])

    x = neighbors.double()
    pl = "projection_layer"
    scores = lin(f"{pl}.attention_final",
                 torch.tanh(lin(f"{pl}.attention_score", x)))
    cst = lin(f"{pl}.cst_output", torch.relu(lin(f"{pl}.cst_hidden", x)))
    h = lin(f"{pl}.weight_sum", (torch.softmax(scores, 1) * cst).sum(1))
    h = F.layer_norm(h, h.shape[-1:], p[f"{pl}.normalization.weight"],
                     p[f"{pl}.normalization.bias"], eps=1e-6)
    x = lin("fuse", torch.cat([tpp.double(),
                               lin(f"{pl}.unified_embedding", h)], -1))
    det = model.detection_model
    for i in range(len(det.linears)):
        x = lin(f"detection_model.linears.{i}", x)
        if i < len(det.linears) - 1:
            bn = f"detection_model.norms.{i}"
            x = torch.relu((x - p[f"{bn}.running_mean"]) * torch.rsqrt(
                p[f"{bn}.running_var"] + det.norms[i].eps)
                * p[f"{bn}.weight"] + p[f"{bn}.bias"])
    return x.squeeze(-1)


def _eval_logits(torch, model, neighbors, tpp):
    """The model's eval-mode logits, its own mode kept."""
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(neighbors, tpp)
    finally:
        model.train(was)


def _trace_names(logdir: str):
    """(kernel names, every event name) of the trace file ``trace``
    wrote into ``logdir``."""
    files = [os.path.join(logdir, f) for f in os.listdir(logdir)
             if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"trace: {len(files)} trace files in {logdir}: "
                             f"{os.listdir(logdir)}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    return kernels, {e.get("name", "") for e in events}, files[0]


def introspect_phase(torch, dev, tmp: str, pipe, card: str):
    """The port's introspection, profiling and debug modules on the card,
    on the train phase's pipeline (wav2vec2-base, D = 5,376, its trained
    BatchNorm head with running statistics, the 25,600-row index): the
    first 256 stored rows as queries, K = 5 neighbors retrieved from the
    index (self-excluded), at B = 64 and 256:

    * ``activations``: exactly ACTIVATION_KEYS (JAX's flax paths), the
      top-level entry equal to the model's logits, every value finite;
    * ``attention_weights`` sum to 1 along K within 1e-5;
    * ``feature_importance`` (B = 64): finite, non-zero, and within 1e-3
      relative of a central difference (h = 1e-6) of the f64 forward's
      logits on 8 seeded coordinates;
    * ``fuse_batch_norm``: the folded model's eval logits within rtol 1e-4,
      atol 1e-5 of the model's, the model unchanged;
    * ``predict_batch_proba(chunk=64)`` within 1e-6 + 1e-5 |p| of
      ``predict_proba`` at B = 256;
    * ``trace``: one ``predict_batch(8)`` and one ``predict_proba`` each in
      an ``annotate`` span; the trace file must name both spans and the
      certified search's three kernels (``gather_rows``, ``exact_dot``,
      ``extract_candidates`` among its kernel events);
    * ``profile_fn`` of that ``predict_batch(8)``; ``memory_stats()``
      (``allocated_bytes.all.peak`` > 0);
    * ``checked`` / ``assert_finite``: a finite input passes in one host
      read (``torch.cuda.set_sync_debug_mode`` counts the synchronizing
      calls; the profiler's device-to-host copies printed), a NaN raises
      ``non-finite values in <name>``; ``nan_debug`` raises inside only.

    The kernel launches of the whole phase are path "introspect": the
    certified search's three kernels must have launched. → {path:
    launches}."""
    import warnings

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from radad_tpu_torch.models import introspect as I
    from radad_tpu_torch.ops.attention import fused_mha
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates, flat_topk
    from radad_tpu_torch.utils import debug, profiling

    kernels = (gather_rows, exact_dot, extract_candidates, fused_mha,
               flat_topk)
    model, ix = pipe.model, pipe.index
    det = model.detection_model
    if not det.use_batch_norm or all(
            bool((bn.running_mean == 0).all()) for bn in det.norms):
        raise AssertionError("introspect: the head has no trained "
                             "BatchNorm statistics")
    clip_dir = os.path.join(tmp, "introspect")
    os.makedirs(clip_dir)
    paths, _ = _write_clips(clip_dir, 8, SEED + 11, "intro")
    pipe.predict_batch(paths)  # warm-up outside the counted run
    torch.cuda.synchronize()
    _reset(kernels, ix)

    tpp = ix.vectors[:256].float()
    neighbors = pipe._retrieve(tpp, ix.ids[:256], "self")[0]
    comp = I.model_complexity(model, batch=256)
    print(f"introspect: model_complexity at B = 256: {comp}")
    d = tpp.shape[1]
    for b in (64, 256):
        nb, tb = neighbors[:b], tpp[:b]
        logits = _eval_logits(torch, model, nb, tb)
        acts = I.activations(model, nb, tb)
        if tuple(acts) != ACTIVATION_KEYS:
            raise AssertionError(f"introspect: activation keys {list(acts)}"
                                 f" are not JAX's {list(ACTIVATION_KEYS)}")
        if not torch.equal(acts["__call__"], logits) or not all(
                bool(torch.isfinite(v).all()) for v in acts.values()):
            raise AssertionError("introspect: the captured logits differ "
                                 "from the model's, or a value is not "
                                 "finite")
        w = I.attention_weights(model, nb)
        w_err = float((w.sum(1) - 1).abs().max())
        if tuple(w.shape) != (b, 5, 1) or not w_err <= 1e-5:
            raise AssertionError(f"introspect: attention weights "
                                 f"{tuple(w.shape)}, |sum - 1| {w_err}")
        before = {k: v.clone() for k, v in model.state_dict().items()}
        folded = _eval_logits(torch, I.fuse_batch_norm(model), nb, tb)
        fold_err = (folded - logits).abs()
        if not bool((fold_err <= 1e-5 + 1e-4 * logits.abs()).all()) or any(
                not torch.equal(v, before[k])
                for k, v in model.state_dict().items()):
            raise AssertionError(f"introspect: fuse_batch_norm at B = {b}: "
                                 f"max |diff| {float(fold_err.max())}, or "
                                 f"the model changed")
        print(f"introspect B = {b}: {len(acts)} activations with JAX's keys, "
              f"logits equal to the model's; attention weights |sum - 1| "
              f"{w_err:.3e}; fuse_batch_norm logits max |diff| "
              f"{float(fold_err.max()):.3e} (rtol 1e-4, atol 1e-5)")

    nb, tb = neighbors[:64], tpp[:64]
    imp = I.feature_importance(model, nb, tb)
    if not bool(torch.isfinite(imp).all()) or not float(imp.sum()) > 0:
        raise AssertionError("introspect: feature importance not finite or "
                             "zero")
    f64 = _fusion_f64(torch, model, nb, tb)
    f64_err = float((f64 - _eval_logits(torch, model, nb, tb)).abs().max())
    h = 1e-6
    cols = torch.randperm(d, generator=torch.Generator().manual_seed(SEED))
    fd_rel = []
    for j in cols[:8].tolist():
        step = torch.zeros_like(tb, dtype=torch.float64)
        step[:, j] = h
        up = _fusion_f64(torch, model, nb, tb.double() + step)
        down = _fusion_f64(torch, model, nb, tb.double() - step)
        fd = float(((up - down) / (2 * h)).abs().mean())
        fd_rel.append(abs(float(imp[j]) - fd) / fd)
    if not max(fd_rel) <= 1e-3:
        raise AssertionError(f"introspect: feature importance against the "
                             f"f64 central difference, relative {fd_rel}")
    print(f"introspect: feature_importance at B = 64 (autograd, f32) "
          f"against an f64 central difference (h = {h}) on 8 coordinates: "
          f"largest relative difference {max(fd_rel):.3e} (limit 1e-3); "
          f"the f64 forward's logits within {f64_err:.3e} of the model's")

    proba = I.predict_proba(model, neighbors, tpp).cpu().numpy()
    chunked = I.predict_batch_proba(model, neighbors, tpp, chunk=64)
    p_err = np.abs(chunked - proba)
    if not (p_err <= 1e-6 + 1e-5 * np.abs(proba)).all():
        raise AssertionError(f"introspect: predict_batch_proba(chunk=64) "
                             f"max |diff| {p_err.max()} from predict_proba")
    print(f"introspect: predict_batch_proba(chunk=64) at B = 256 within "
          f"{p_err.max():.3e} of predict_proba")

    logdir = os.path.join(tmp, "introspect_trace")
    spans = ("radad_predict_batch_8", "radad_predict_proba_256")
    with profiling.trace(logdir):
        with profiling.annotate(spans[0]):
            pipe.predict_batch(paths)
        with profiling.annotate(spans[1]):
            I.predict_proba(model, neighbors, tpp)
        torch.cuda.synchronize()
    kernel_names, names, trace_file = _trace_names(logdir)
    found = {k: sorted(n for n in kernel_names if k in n)[:2]
             for k in ("gather_rows", "exact_dot", "extract_candidates")}
    missing = [s_ for s_ in spans if s_ not in names] + [
        k for k, v in found.items() if not v]
    if missing:
        raise AssertionError(f"introspect: the trace names no {missing} "
                             f"({len(kernel_names)} kernel names)")
    print(f"introspect: trace {os.path.basename(trace_file)} "
          f"({os.path.getsize(trace_file)} bytes, {len(kernel_names)} "
          f"kernel names) names the spans {list(spans)} and the kernels "
          f"{found}")

    stats = profiling.profile_fn(pipe.predict_batch, paths, iterations=10,
                                 label="predict_batch_8")
    print(f"introspect: profile_fn predict_batch(8): median "
          f"{stats['median_ms']:.3f} ms, mean {stats['mean_ms']:.3f}, p90 "
          f"{stats['p90_ms']:.3f} over {stats['iterations']} calls (CUDA "
          f"events) ({card})")
    mem = profiling.memory_stats()
    if not mem.get("allocated_bytes.all.peak", 0) > 0:
        raise AssertionError(f"introspect: memory_stats has no peak: "
                             f"{sorted(mem)[:8]}")
    print(f"introspect: memory_stats: {len(mem)} counters, "
          f"allocated_bytes.all.peak "
          f"{mem['allocated_bytes.all.peak'] / 2**30:.2f} GiB")

    def guarded(x):
        debug.assert_finite(x, "neighbors")
        y = debug.sanitize(x) * 2.0
        debug.assert_finite(y, "doubled")
        return y

    run = debug.checked(guarded)
    run(nb)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught, profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(nb)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(c.message) for c in caught
             if "called a synchronizing" in str(c.message)]
    dtoh = sum(e.count for e in prof.key_averages() if "DtoH" in e.key)
    if len(syncs) != 1:
        raise AssertionError(f"checked: {len(syncs)} synchronizing calls in "
                             f"one call, want 1: {syncs}")
    bad = nb.clone()
    bad[3, 2, 7] = float("nan")
    try:
        run(bad)
    except ValueError as e:
        if str(e) != "non-finite values in neighbors":
            raise
    else:
        raise AssertionError("checked: a NaN input did not raise")
    with debug.nan_debug():
        try:
            torch.log(torch.full((4,), -1.0, device=dev))
        except FloatingPointError:
            pass
        else:
            raise AssertionError("nan_debug: a NaN passed")
    if not bool(torch.isnan(torch.log(torch.full((4,), -1.0,
                                                 device=dev))).all()):
        raise AssertionError("after nan_debug: log(-1) is not NaN")
    print(f"introspect: checked(fn) with 2 assert_finite on CUDA tensors: "
          f"1 synchronizing call (sync debug mode), {dtoh} device-to-host "
          f"copies (profiler); a NaN raised 'non-finite values in "
          f"neighbors'; nan_debug raised FloatingPointError inside, not "
          f"outside")

    torch.cuda.synchronize()
    launches = _launch_counts(kernels, ix)
    for name in ("gather_rows", "exact_dot", "extract_candidates"):
        if launches[name] <= 0:
            raise AssertionError(f"introspect: {name} not launched: "
                                 f"{launches}")
    print(f"introspect path: kernel launches {launches}")
    return {"introspect": launches}


def train_bf16_phase(torch, dev, tmp: str):
    """The trainer in mixed precision at the shipped defaults
    (use_mixed_precision=True: the fusion model in bf16 with f32
    parameters, the encoder in bf16) with RADAD_FUSED_ATTENTION=1, on the
    train phase's clips and DB size: the card's first update (dropout 0,
    the fresh model and optimizer state) against the CPU's bf16 update on
    the same inputs (BF16_UPDATE_LIMITS); ``train`` for 1 epoch and
    ``evaluate``, counted on path "train_bf16" (losses finite, the
    certified search's kernels launched, and fused_mha's bias-free bf16
    body: the encoder embeds the validation clips inside ``train``); save
    -> load keeps the optimizer state and step; step timings. Returns
    {path: launches}."""
    os.environ["RADAD_FUSED_ATTENTION"] = "1"
    try:
        return _train_bf16(torch, dev, tmp)
    finally:
        os.environ.pop("RADAD_FUSED_ATTENTION", None)


def _train_bf16(torch, dev, tmp: str):
    import numpy as np

    from radad_tpu_torch.config import Config
    from radad_tpu_torch.ops.attention import fused_mha
    from radad_tpu_torch.ops.gather import gather_rows
    from radad_tpu_torch.ops.rerank import exact_dot
    from radad_tpu_torch.ops.topk import extract_candidates, flat_topk
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    root = os.path.join(tmp, "train_bf16")
    cfg = Config().replace(
        data_root=root, vector_db_path=os.path.join(root, "vdb"),
        train_data_path=os.path.join(root, "clips"), random_seed=SEED,
        num_epochs=1, use_mixed_precision=True)
    os.makedirs(cfg.train_data_path)
    train_m = _manifest(*_write_clips(cfg.train_data_path, TRAIN_CLIPS,
                                      SEED + 5, "train"))
    val_m = _manifest(*_write_clips(cfg.train_data_path, VAL_CLIPS, SEED + 6,
                                    "val"))
    pipe = DetectionPipeline(cfg, device=dev)
    if pipe.model.compute_dtype != torch.bfloat16:
        raise AssertionError("use_mixed_precision did not give a bf16 model")
    t0 = time.perf_counter()
    pipe.build_vector_database(train_m, save=False)
    torch.cuda.synchronize()
    print(f"train bf16 phase: build_vector_database {len(train_m)} clips in "
          f"{time.perf_counter() - t0:.2f} s (bf16 encoder)")
    _pad_index(torch, pipe, INDEX_ROWS, SEED + 7)
    ix = pipe.index

    pipe._ensure_model_state()
    steps = pipe._steps()
    batch = list(pipe._query_batches(train_m, cfg.batch_size, shuffle=True,
                                     seed=SEED))[-1]
    neighbors, _ = steps.fetch(batch[0], batch[2])
    errs = _update_on_cpu(torch, pipe, batch, neighbors,
                          limits=BF16_UPDATE_LIMITS)
    print("train bf16 first update, card against CPU (dropout 0, bf16 both): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (limits {BF16_UPDATE_LIMITS}; the rest as the f32 check)")

    kernels = (gather_rows, exact_dot, extract_candidates, fused_mha,
               flat_topk)
    torch.cuda.synchronize()
    _reset(kernels, ix)
    t0 = time.perf_counter()
    pipe.train(train_m, val_m)
    result = pipe.evaluate(val_m)
    torch.cuda.synchronize()
    launches = _launch_counts(kernels, ix)
    secs = time.perf_counter() - t0
    row = [r for r in pipe.writer.rows if r["epoch"] != "eval"][-1]
    print(f"train bf16 epoch 1: train loss {row['train_loss']:.6f}, val loss "
          f"{row['val_loss']:.6f}, EER {row['eer_percent']:.4f} %; evaluate "
          f"loss {result['loss']:.6f}, EER {result['eer_percent']:.4f} %; "
          f"train + evaluate {secs:.2f} s, {pipe.step} steps, "
          f"{ix.searches} searches, {ix.fallbacks} fallbacks; kernel "
          f"launches {launches}")
    if not (np.isfinite(row["train_loss"]) and np.isfinite(row["val_loss"])
            and np.isfinite(result["loss"])):
        raise AssertionError("non-finite loss in bf16 training")
    for name in ("gather_rows", "exact_dot", "extract_candidates",
                 "fused_mha_bf16"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"bf16 training path")
    if launches["fused_mha"] or launches["flat_topk"]:
        raise AssertionError(f"the bf16 training path launched an f32 "
                             f"attention or flat_topk: {launches}")
    _resident_only(launches, "train_bf16")
    _gelu_fused_only(launches, "train_bf16")
    _exact_dot_form_only(launches, "train_bf16", "per_query")

    fresh = _resumed(torch, pipe, cfg, dev)
    print(f"train bf16 resume: optimizer state, step {pipe.step} and f32 "
          f"parameters equal after save -> load_models")
    medians, steps_per_s, busy, wall_ms = _step_times(torch, fresh, train_m)
    print(f"train bf16 step at B = {cfg.batch_size}: median ms retrieve "
          f"{medians['retrieve']:.3f}, forward+backward "
          f"{medians['forward_backward']:.3f}, update "
          f"{medians['update']:.3f} (CUDA-synchronized, 12 steps); "
          f"{steps_per_s:.2f} steps/s over an epoch of train_step; device "
          f"busy {busy:.3f} of one profiled step ({wall_ms:.2f} ms)")
    del pipe, fresh
    return {"train_bf16": launches}


# ---------------------------------------------------------------- the mesh
# the mesh phase's worlds: (label, backend, ranks, what each runs)
MESH_WORLDS = (("world1_nccl", "nccl", 1, ("serve", "steps1")),
               ("world2_gloo", "gloo", 2,
                ("probe", "serve", "sq8", "ivf", "refined", "steps3",
                 "epoch", "tp")),
               ("world4_gloo", "gloo", 4, ("serve64", "steps1")))
MESH_TIMEOUT_S = 60  # each world's collective timeout
MESH_DEADLINE_S = 420  # each world's join deadline
MESH_STEP_B = 128
MESH_SQ8_NLIST = 1024


def _mesh_shape(world: int, case: str):
    """The mesh a case runs on: serving, SQ8, IVF and TP over 'index'
    (1 x world, or 2 x 2), training over 'data' (world x 1, or 2 x 2)."""
    if world == 4:
        return (2, 2)
    return (world, 1) if case.startswith(("steps", "epoch")) else (1, world)


def _mesh_serve_cfg(job):
    from radad_tpu_torch.config import Config

    return Config().replace(**job["serve_cfg"])


def _mesh_encoder(job, mesh):
    """The serving phase's encoder (seeded random wav2vec2-base), built
    once a rank."""
    from radad_tpu_torch.models.encoder import build_encoder

    if "encoder" not in job["cache"]:
        job["cache"]["encoder"] = build_encoder(_mesh_serve_cfg(job),
                                                device=mesh.device)
    return job["cache"]["encoder"]


def _mesh_new_pipeline(mesh, job, **over):
    """A DetectionPipeline on ``mesh`` with the serving phase's encoder and
    fusion weights (both seeded) and ``over`` in its configuration."""
    from radad_tpu_torch.train.pipeline import DetectionPipeline

    return DetectionPipeline(_mesh_serve_cfg(job).replace(**over),
                             encoder=_mesh_encoder(job, mesh), mesh=mesh)


def _mesh_pipeline(torch, mesh, job, **over):
    """``_mesh_new_pipeline`` with the serving phase's saved 25,600-row
    table loaded."""
    pipe = _mesh_new_pipeline(mesh, job, **over)
    if not pipe.load_vector_database():
        raise AssertionError("the mesh pipeline found no saved table")
    return pipe


def _gather_rows(mesh, t):
    from radad_tpu_torch.parallel.mesh import DATA_AXIS

    return mesh.all_gather(t, DATA_AXIS).flatten(0, 1)


def _mesh_embed(torch, pipe, paths):
    """The clips' embeddings as predict_batch makes them on this mesh (each
    rank its slice, all-gathered)."""
    import numpy as np

    from radad_tpu_torch.data.audio import load_audio

    cfg, mesh = pipe.config, pipe.mesh
    waves = np.stack([load_audio(p, sample_rate=cfg.sample_rate,
                                 duration=cfg.clip_duration) for p in paths])
    local = pipe._data_slice(len(paths))
    return _gather_rows(mesh, pipe._embed(torch.as_tensor(
        waves[local], device=pipe.device))).cpu()


def _timed_serve(torch, pipe, paths, reps: int):
    """predict_batch(paths) once to warm up, then ``reps`` times. → (the
    last payloads, host ms of each call)."""
    pipe.predict_batch(paths)
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = pipe.predict_batch(paths)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def _payload_rows(pipe, outs):
    rows = {os.path.basename(p): i for i, p in enumerate(pipe.index.paths)}
    return [[rows[f] for f in o["retrieved_files"]] for o in outs]


def _case_serve(torch, mesh, job, sizes=(8, 64)):
    """The flat pipeline's predict_batch at each B with self exclusion:
    neighbors, logits and the embeddings it used, for the main process to
    hold to the f64 scan and to the one-device fusion model; call ms;
    one B = 64 call's collectives."""
    pipe = _mesh_pipeline(torch, mesh, job)
    out = {"rows_a_rank": int(pipe.sharded.vectors.shape[0])}
    for b in sizes:
        paths = job["sets"][b]
        outs, ms = _timed_serve(torch, pipe, paths, 3)
        out[f"b{b}"] = {"rows": _payload_rows(pipe, outs),
                        "logits": [o["logit"] for o in outs],
                        "dists": [[r["distance"] for r in o["retrieved"]]
                                  for o in outs],
                        "tpp": _mesh_embed(torch, pipe, paths), "ms": ms}
    mesh.reset_counts()
    pipe.predict_batch(job["sets"][64])
    out["calls_b64"] = dict(mesh.calls)
    return out


def _hold_plain(torch, got, want, label):
    """Ids equal and distances within 1e-5 relative: a mesh search against
    its plain single-process form."""
    gi, wi = got.indices.cpu(), want.indices.cpu()
    if not torch.equal(gi, wi):
        raise AssertionError(f"{label}: ids differ from the plain form on "
                             f"{int((gi != wi).any(-1).sum())} rows")
    gd, wd = got.dists.double().cpu(), want.dists.double().cpu()
    ok = torch.isfinite(wd)
    err = float(((gd - wd).abs() / wd.abs().clamp_min(1e-30))[ok].max())
    if not err <= 1e-5:
        raise AssertionError(f"{label}: distances off the plain form's by "
                             f"{err:.3e} relative")
    return err


def _cpu_text(held) -> str:
    """``_hold_to_cpu``'s counts in words."""
    same, skipped, rel, share = held
    return (f"ids identical on {same} ({skipped} rows with a probe "
            f"flipped within rounding not compared); relative distance "
            f"error {rel:.2e}; largest gap {share:.3f} of its bound")


def _table_from_flat(torch, job):
    """The saved flat table (host): vectors, labels, paths, ids."""
    import pickle

    import numpy as np

    data = np.load(os.path.join(job["vdb"], "index_arrays.npz"))
    with open(os.path.join(job["vdb"], "index_host.pkl"), "rb") as f:
        host = pickle.load(f)  # written by this script's serving phase
    return (data["vectors"], data["labels"].tolist(), list(host["paths"]),
            data["ids"].tolist())


def _searched(torch, pipe, paths, mode):
    """The sharded search (the rank's ``ShardedIndex``) of ``paths``' embeddings on
    this mesh, gathered over 'data', and the same embeddings."""
    from radad_tpu_torch.data.manifest import file_id
    from radad_tpu_torch.parallel.sharded_index import ShardedRetrieval

    mesh = pipe.mesh
    tpp = _mesh_embed(torch, pipe, paths).to(pipe.device)
    excl = torch.as_tensor([file_id(p) for p in paths], dtype=torch.int32,
                           device=pipe.device)
    local = pipe._data_slice(len(paths))
    ret = pipe._retrieve(tpp[local], excl[local], mode,
                         prefer_ivf_gather=True)
    return ShardedRetrieval(*(_gather_rows(mesh, t) for t in ret)), tpp, excl


def _case_sq8(torch, mesh, job):
    """SQ8 plain and residual (nlist 1,024) on the mesh: the table in one
    add, each rank keeping its block; B = 8 and 64 held to the plain
    form's ids and distances on the card, and on rank 0 to the plain form
    run on the CPU copies of the same arrays (``_hold_to_cpu``)."""
    from radad_tpu_torch.index.quantized import _dequantize
    from radad_tpu_torch.parallel.sharded_index import (
        pad_rows, plain_sharded_retrieve_sq8)

    table = _table_from_flat(torch, job)
    out = {}
    for label, nlist in (("sq8", 0), ("sq8_residual", MESH_SQ8_NLIST)):
        pipe = _mesh_new_pipeline(mesh, job, vector_db_index_type="SQ8",
                                  sq8_residual_nlist=nlist)
        cfg = pipe.config
        t0 = time.perf_counter()
        pipe.index.add(table[0], table[1], table[2], ids=table[3])
        pipe._place_index_on_mesh()
        rec = {"build_s": time.perf_counter() - t0,
               "rows_a_rank": int(pipe.sharded.codes.shape[0])}
        ix, dev = pipe.index, pipe.device  # the index itself on the host
        cap = pipe.sharded.codes.shape[0] * mesh.index
        host = [pad_rows(t, cap, f) for t, f in (
            (ix.codes, 0), (ix.scales, 0), (ix.norm_sq, 0), (ix.labels, 0),
            (ix.ids, -1))]
        cents = ix.centroids
        cells = None if ix.cells is None else pad_rows(ix.cells, cap)

        def plain(tpp, excl, d):
            return plain_sharded_retrieve_sq8(
                tpp.to(d), *(t.to(d) for t in host), excl.to(d),
                shards=mesh.index, k=cfg.top_k,
                centroids=None if cents is None else cents.to(d),
                cells=None if cells is None else cells.to(d),
                exclude_mode="self")

        def recon(rows):
            return _dequantize(rows.reshape(-1), host[0], host[1], cents,
                               cells).double().reshape(rows.shape + (-1,))

        for b in (8, 64):
            got, tpp, excl = _searched(torch, pipe, job["sets"][b], "self")
            rec[f"b{b}_err"] = _hold_plain(torch, got, plain(tpp, excl, dev),
                                           f"{label} B={b}")
            if mesh.rank == 0:
                want = plain(tpp, excl, "cpu")
                rec[f"b{b}_cpu"] = _hold_to_cpu(
                    torch, got.indices, got.dists, want.indices, want.dists,
                    tpp, recon, f"{label} B={b} against the CPU")
            _, ms = _timed_serve(torch, pipe, job["sets"][b], 3)
            rec[f"b{b}_ms"] = ms
        out[label] = rec
        del pipe
    return out


def _case_ivf(torch, mesh, job):
    """IVF at the shipped nlist 4,096 / nprobe 32 on the mesh: B = 64 takes
    the masked route, B = 1 the sharded gather route (each rank's gate
    recorded); each held to the plain form of its search on the card, and
    on rank 0 to the plain form run on the CPU copies of the same arrays
    (``_hold_to_cpu``; a probe may flip within the centroid distances'
    rounding, ``_probe_flips``)."""
    from radad_tpu_torch.index.flat import probe_cells
    from radad_tpu_torch.parallel.sharded_index import (
        build_sharded_chunk_tables, pad_rows, plain_sharded_retrieve,
        plain_sharded_retrieve_ivf_gather)

    table = _table_from_flat(torch, job)
    pipe = _mesh_new_pipeline(mesh, job, vector_db_index_type="IVF",
                              vector_db_nlist=IVF_NLIST,
                              vector_db_nprobe=IVF_NPROBE)
    cfg = pipe.config
    t0 = time.perf_counter()
    pipe.index.add(table[0], table[1], table[2], ids=table[3])
    pipe._place_index_on_mesh()
    ix, dev, k = pipe.index, pipe.device, cfg.top_k  # ix on the host
    rows = int(pipe.sharded.vectors.shape[0])
    cap = rows * mesh.index
    nprobe = min(ix.nprobe, ix.centroids.shape[0])
    budget = pipe.sharded.gather_budget(nprobe)
    w = int(pipe.sharded.chunk_rows.shape[1])
    out = {"build_s": time.perf_counter() - t0, "rows_a_rank": rows,
           "budget": budget, "chunk": w}
    cells = pad_rows(ix.cells, cap)
    ids = pad_rows(ix.ids, cap, -1)
    full = (pad_rows(ix.vectors, cap), pad_rows(ix.labels, cap), ids)
    cents = ix.centroids
    cr, cc, nvs, _ = build_sharded_chunk_tables(cells.numpy(), ix.n,
                                                cents.shape[0], mesh.index)
    cr, cc = torch.as_tensor(cr), torch.as_tensor(cc)

    def plain(route, mode, tpp, excl, d):
        if route == "masked":
            return plain_sharded_retrieve(
                tpp.to(d), *(t.to(d) for t in full), ids.to(d) >= 0,
                excl.to(d), shards=mesh.index, k=k, centroids=cents.to(d),
                cells=cells.to(d), nprobe=ix.nprobe, exclude_mode=mode)
        return plain_sharded_retrieve_ivf_gather(
            tpp.to(d), *(t.to(d) for t in full), excl.to(d), cents.to(d),
            cells.to(d), cr.to(d), cc.to(d), nvs, shards=mesh.index, k=k,
            nprobe=nprobe, budget=budget, exclude_mode=mode)

    def recon(r):
        return full[0][r].double()

    for b, mode in ((64, "self"), (1, "batch")):
        paths = job["sets"][b]
        b_loc = len(paths) // mesh.data
        gate = 2 * b_loc * budget * w
        route = "gather" if gate < rows else "masked"
        before = ix.ivf_gather_searches
        got, tpp, excl = _searched(torch, pipe, paths, mode)
        took = "gather" if ix.ivf_gather_searches > before else "masked"
        if took != route:
            raise AssertionError(f"IVF B={b}: took the {took} route where "
                                 f"the gate picks {route}")
        out[f"b{b}"] = {"gate": f"2 b budget chunk = 2 x {b_loc} x {budget}"
                                f" x {w} = {gate} vs {rows} rows a shard: "
                                f"{route}",
                        "err": _hold_plain(torch, got,
                                           plain(route, mode, tpp, excl,
                                                 dev),
                                           f"IVF B={b} ({route})")}
        if mesh.rank == 0:
            np_eff = nprobe if route == "gather" else ix.nprobe
            p_card = probe_cells(tpp.float(), cents.to(dev),
                                 np_eff).sort(-1).values.cpu()
            p_cpu = probe_cells(tpp.float().cpu(), cents,
                                np_eff).sort(-1).values
            flipped = _probe_flips(torch, cents, tpp.float().cpu(), p_card,
                                   p_cpu, np_eff)
            want = plain(route, mode, tpp, excl, "cpu")
            out[f"b{b}"]["cpu"] = _hold_to_cpu(
                torch, got.indices, got.dists, want.indices, want.dists, tpp,
                recon, f"IVF B={b} ({route}) against the CPU", flipped)
        if b == 1:
            t_ms = []
            for _ in range(5):
                t0 = time.perf_counter()
                pipe.predict(paths[0])
                t_ms.append((time.perf_counter() - t0) * 1e3)
            out["b1_predict_ms"] = t_ms
        else:
            out[f"b{b}_ms"] = _timed_serve(torch, pipe, paths, 3)[1]
    out["gather_searches"] = ix.ivf_gather_searches
    out["gather_scans"] = ix.ivf_gather_fallbacks
    return out


def _case_refined(torch, mesh, job):
    """A refined SQ8 configuration is refused on a mesh."""
    try:
        _mesh_new_pipeline(mesh, job, vector_db_index_type="SQ8",
                           sq8_refine_bits=4)
    except ValueError as e:
        return {"raised": str(e)}
    raise AssertionError("a refined SQ8 index was built on a mesh")


def _case_tp(torch, mesh, job):
    """wav2vec2-base tensor-parallel over 'index' (6 of 12 heads a rank)
    through fused_mha f32: embeddings against the replicated encoder's with
    the plain attention (``mha_reference``) on this rank's clips, so the
    launches at the mesh's shape are held to the plain version on the same
    inputs; fused_mha's launches counted on the TP run alone."""
    import dataclasses

    import numpy as np

    from radad_tpu_torch.data.audio import load_audio
    from radad_tpu_torch.ops import attention
    from radad_tpu_torch.parallel import shard_encoder_params
    from radad_tpu_torch.train.pipeline import make_embed_fn

    cfg = _mesh_serve_cfg(job)
    enc = _mesh_encoder(job, mesh)
    tp_enc = dataclasses.replace(enc, model=shard_encoder_params(enc.model,
                                                                 mesh))
    paths = job["sets"][8]
    audio = torch.as_tensor(np.stack([load_audio(
        p, sample_rate=cfg.sample_rate, duration=cfg.clip_duration)
        for p in paths]), device=mesh.device)
    os.environ.pop("RADAD_FUSED_ATTENTION", None)
    ref = make_embed_fn(enc, cfg)(audio)  # the plain attention
    torch.cuda.synchronize()
    os.environ["RADAD_FUSED_ATTENTION"] = "1"
    try:
        attention.reset_launches()
        mesh.reset_counts()
        got = make_embed_fn(tp_enc, cfg)(audio)
        torch.cuda.synchronize()
        launches = dict(attention.fused_mha.body_launches)
        calls = dict(mesh.calls)
    finally:
        os.environ.pop("RADAD_FUSED_ATTENTION", None)
    diff = (got - ref).abs()
    bound = 1e-5 + 2e-4 * ref.abs()
    if not bool((diff <= bound).all()):
        raise AssertionError(f"TP encoder: embeddings beyond rtol 2e-4, "
                             f"atol 1e-5 (max |diff| {float(diff.max()):.3e})")
    return {"max_abs": float(diff.max()), "fused_mha": launches,
            "calls": calls,
            "heads_a_rank": (enc.arch_cfg.num_attention_heads
                             // mesh.index),
            "qw_rows": int(tp_enc.model.layers[0]["attn"]["qw"].shape[0])}


def _mesh_step_state(model, opt):
    """The model's and the optimizer's state (CPU copies)."""
    return ({k: v.detach().cpu().clone() for k, v in
             model.state_dict().items()},
            {g: {"count": s["count"].cpu().clone(),
                 "mu": {n: t.cpu().clone() for n, t in s["mu"].items()},
                 "nu": {n: t.cpu().clone() for n, t in s["nu"].items()}}
             for g, s in opt.state.items()})


def _adam_moments(opt):
    """The optimizer's first and second moments after a step, by group
    (CPU copies)."""
    return {g: {key: {n: t.cpu().clone() for n, t in st[key].items()}
                for key in ("mu", "nu")} for g, st in opt.state.items()}


def _case_steps(torch, mesh, job, n_steps: int):
    """``n_steps`` train steps at B = 128 with the shipped BatchNorm head and
    dropout 0 on the table's rows as queries (batch exclusion): each step's
    starting state, neighbors, result and ms, for the main process to hold
    to the single-device trainer; the parameters must be bit-equal on
    every rank."""
    from radad_tpu_torch.parallel.mesh import DATA_AXIS, INDEX_AXIS
    from radad_tpu_torch.train.pipeline import new_accumulators

    pipe = _mesh_pipeline(torch, mesh, job, use_batch_norm=True,
                          projection_dropout=0.0, detection_dropout=0.0)
    pipe._ensure_model_state()
    steps = pipe._steps()
    ix, dev = pipe.index, pipe.device
    local = pipe._data_slice(MESH_STEP_B)

    def batch_of(rows):
        rows_t = torch.as_tensor(rows)[local]
        return (ix.vectors[rows_t].float().to(dev),
                ix.labels[rows_t].to(dev), ix.ids[rows_t].to(dev),
                torch.ones(len(rows_t), dtype=torch.bool, device=dev))

    # one untimed step warms the card's kernels; the state is put back
    start = _mesh_step_state(pipe.model, pipe.opt)
    steps.train_step(new_accumulators(dev), *batch_of(job["step_rows"][0]),
                     1.0, pipe.generator)
    pipe.model.load_state_dict(start[0])
    pipe.opt.load_state_dict(start[1], device=dev)
    out = []
    for rows in job["step_rows"][:n_steps]:
        batch = batch_of(rows)
        start = _mesh_step_state(pipe.model, pipe.opt)
        # the neighbors the step retrieves (the same search runs in it)
        idx = _gather_rows(mesh, pipe._retrieve(batch[0], batch[2],
                                                "batch")[3]).cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bm = steps.train_step(new_accumulators(dev), batch[0], batch[1],
                              batch[2], batch[3], 1.0, pipe.generator)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        det = pipe.model.detection_model
        rec = {"ms": ms, "idx": idx,
               "metrics": {k: float(bm[k]) for k in
                           ("loss", "acc", "gn_proj", "gn_fuse", "gn_det")},
               "params": {n: p.detach().cpu().clone()
                          for n, p in pipe.model.named_parameters()},
               "bn": [(bn.running_mean.cpu().clone(),
                       bn.running_var.cpu().clone()) for bn in det.norms]}
        if mesh.rank == 0:
            rec["start"] = start
            rec["adam"] = _adam_moments(pipe.opt)
        out.append(rec)
    # parameters bit-equal on every rank: the largest |delta| to rank 0's
    flat = torch.cat([p.detach().reshape(-1)
                      for p in pipe.model.parameters()])
    spread = 0.0
    for axis in (DATA_AXIS, INDEX_AXIS):
        g = mesh.all_gather(flat, axis)
        spread = max(spread, float((g - g[:1]).abs().max()))
    return {"steps": out, "param_spread": spread}


def _case_epoch(torch, mesh, job):
    """1 epoch at the shipped defaults (dropout 0.1) on the serving phase's
    256 DB clips, validated and then ``evaluate``d on its 64 query clips:
    finite losses."""
    import numpy as np

    from radad_tpu_torch.data.manifest import Manifest, file_id

    def manifest(paths):
        labels = np.asarray([1.0 if i % 3 else 0.0
                             for i in range(len(paths))], np.float32)
        return Manifest(paths=tuple(paths), labels=labels,
                        speakers=tuple(f"spk{i % 8}"
                                       for i in range(len(paths))),
                        ids=np.asarray([file_id(p) for p in paths],
                                       np.int32))

    pipe = _mesh_pipeline(torch, mesh, job, use_batch_norm=True,
                          num_epochs=1, batch_size=MESH_STEP_B,
                          eval_batch_size=MESH_STEP_B)
    t0 = time.perf_counter()
    row = pipe.train(manifest(job["db_paths"]), manifest(job["q_paths"]))
    res = pipe.evaluate(manifest(job["q_paths"]))
    if not (np.isfinite(row["train_loss"]) and np.isfinite(res["loss"])):
        raise AssertionError(f"mesh epoch: non-finite loss ({row}, {res})")
    return {"train_loss": row["train_loss"], "val_loss": row["val_loss"],
            "eval_loss": res["loss"], "s": time.perf_counter() - t0}


def _case_probe(torch, mesh, job):
    """Whether gloo takes the mesh's two collectives on CUDA tensors of
    each dtype that the mesh moves (each tried on every rank alike; a
    refused one raises before any data moves), and gives the right
    sums."""
    import torch.distributed as dist

    taken = {}
    for dtype in (torch.float32, torch.int32, torch.bool):
        x = torch.full((4,), mesh.rank + 1, device=mesh.device).to(dtype)
        calls = {"all_reduce": lambda: dist.all_reduce(x.clone()),
                 "all_gather": lambda: dist.all_gather(
                     [torch.empty_like(x) for _ in range(mesh.world)], x)}
        for name, call in calls.items():
            key = f"{name} {str(dtype).split('.')[-1]}"
            if name == "all_reduce" and dtype == torch.bool:
                continue  # the mesh sums no bool
            try:
                call()
                torch.cuda.synchronize()
                taken[key] = True
            except RuntimeError as e:
                taken[key] = f"refused: {str(e).splitlines()[0][:120]}"
    if taken.get("all_reduce float32") is True:
        got = mesh.all_reduce(torch.ones(3, device=mesh.device), "index")
        taken["all_reduce sums"] = bool((got == mesh.index).all())
    if mesh.rank == 0:  # printed here too, in case a later case fails
        print(f"mesh probe: gloo with CUDA tensors takes {taken}",
              flush=True)
    return taken


MESH_CASES = {"probe": _case_probe, "serve": _case_serve,
              "serve64": lambda t, m, j: _case_serve(t, m, j, sizes=(64,)),
              "sq8": _case_sq8, "ivf": _case_ivf, "refined": _case_refined,
              "tp": _case_tp,
              "steps1": lambda t, m, j: _case_steps(t, m, j, 1),
              "steps3": lambda t, m, j: _case_steps(t, m, j, 3),
              "epoch": _case_epoch}


def _mesh_rank(rank, world, backend, out_dir, job):
    """One rank of a mesh world on cuda:0: its process group (60 s
    collective timeout), each case of the world on its mesh, results
    pickled for the main process (this script's own files)."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    from radad_tpu_torch.parallel import make_mesh
    from radad_tpu_torch.utils.device import resolve_device

    torch.cuda.set_device(0)
    resolve_device("cuda:0")  # TF32 off, as the main process
    job = dict(job, cache={})  # this rank's encoder, built once
    dist.init_process_group(
        backend, init_method=f"file://{out_dir}/store", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        meshes, out = {}, {}
        for case in job["cases"]:
            shape = _mesh_shape(world, case)
            if shape not in meshes:  # every rank builds every group
                meshes[shape] = make_mesh(*shape, device="cuda:0")
            mesh = meshes[shape]
            mesh.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = MESH_CASES[case](torch, mesh, job)
            torch.cuda.synchronize()
            out[case] = {"res": res, "shape": shape,
                         "s": time.perf_counter() - t0,
                         "calls": dict(mesh.calls),
                         "peak_gib": torch.cuda.max_memory_allocated()
                         / 2**30}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _run_mesh_world(label, backend, world, job, tmp):
    """Spawn a world's ranks and wait for them: a rank that fails fails the
    world; ranks still running at the deadline are killed and the world
    fails. → each rank's results."""
    import pickle

    import torch.multiprocessing as mp

    out_dir = os.path.join(tmp, label)
    os.makedirs(out_dir)
    ctx = mp.start_processes(_mesh_rank, args=(world, backend, out_dir, job),
                             nprocs=world, join=False, start_method="spawn")
    end = time.perf_counter() + MESH_DEADLINE_S
    try:
        while not ctx.join(timeout=max(0.1, end - time.perf_counter())):
            if time.perf_counter() >= end:
                raise AssertionError(f"mesh {label}: ranks still running "
                                     f"at the {MESH_DEADLINE_S} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    outs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))  # written by _mesh_rank above
    return outs


def _mesh_hold_serving(torch, pipe, res, paths, label):
    """A mesh's predict_batch against the one-device pipeline: the
    embeddings within 1e-4 relative of the one-device ones, the neighbors
    held to the f64 scan of the mesh's own embeddings (``_hold_to_f64``),
    every logit within 1e-4 of the one-device fusion model on the same
    embedding and neighbors."""
    from radad_tpu_torch.data.manifest import file_id

    ix, k = pipe.index, pipe.config.top_k
    base = _embed_paths(torch, pipe, paths)
    tpp = res["tpp"].to(ix.device)
    drel = float(((tpp - base).double().norm(dim=-1)
                  / base.double().norm(dim=-1)).max())
    excl = torch.as_tensor([file_id(p) for p in paths], device=ix.device,
                           dtype=torch.int32)
    rows = torch.as_tensor(res["rows"], device=ix.device)
    held = _hold_to_f64(torch, ix, tpp, _exclusion_mask(torch, ix, excl,
                                                        "self"), rows, k)
    with torch.no_grad():
        replay = pipe.model(ix.vectors[rows].float(), tpp).float().cpu()
    dlogit = float((replay - torch.as_tensor(res["logits"])).abs().max())
    if not (drel <= 1e-4 and dlogit <= 1e-4):  # a NaN fails too
        raise AssertionError(f"{label}: embeddings {drel:.3e} relative from "
                             f"the one-device ones, logits {dlogit:.3e} "
                             f"from the one-device model (limits 1e-4)")
    print(f"{label}: {_held_text(held)}; embeddings within {drel:.3e} "
          f"relative, logits within {dlogit:.3e} of the one-device model")


def _mesh_single_steps(torch, pipe, recs, job, label):
    """Each recorded mesh step against the single-device trainer started
    from the same state. The step's neighbors are held to the f64 scan
    (``_hold_to_f64``, batch exclusion): a rank's search of its slice of
    the batch runs a smaller f32 GEMM than the one-device search, so
    neighbors tied within f32 rounding may trade places. The single-device
    step then updates from the same neighbors (``StepFns.update``), and the
    mesh step's result is held by tests/test_torch_train.py's rule
    (``_hold_step``): loss, accuracy and the three gradient norms within
    1e-5 relative; BatchNorm running statistics within 1e-5; both Adam
    moments within 1e-4 of their group's largest value; parameters within
    1e-6 + 1e-5 |p| except where Adam's input is rounding, seen as the two
    first moments disagreeing by more than 0.1 % (there a step may move a
    coordinate by up to 2 lr), at most 0.5 % of the coordinates such, and
    all within 2 lr."""
    from radad_tpu_torch.models.fusion import build_radad_model
    from radad_tpu_torch.train.optim import GroupAdam
    from radad_tpu_torch.train.pipeline import (make_step_fns,
                                                new_accumulators)

    cfg = _mesh_serve_cfg(job).replace(use_batch_norm=True,
                                       projection_dropout=0.0,
                                       detection_dropout=0.0)
    ix, dev, k = pipe.index, pipe.device, cfg.top_k
    model = build_radad_model(cfg, pipe.tpp_dim).to(dev)
    opt = GroupAdam(cfg.learning_rate, cfg.weight_decay)
    steps = make_step_fns(model, opt, None)
    faults, report = [], []
    for i, (rec, rows) in enumerate(zip(recs, job["step_rows"])):
        rows_t = torch.as_tensor(rows, device=dev)
        tpp = ix.vectors[rows_t].float()
        excl = ix.ids[rows_t]
        idx = rec["idx"].to(dev).long()
        held = _hold_to_f64(torch, ix, tpp, _exclusion_mask(
            torch, ix, excl, "batch"), idx, k)
        neighbors = torch.where((idx >= 0)[..., None],
                                ix.vectors[idx.clamp_min(0)].float(),
                                torch.zeros((), device=dev))
        model.load_state_dict(rec["start"][0])
        opt.load_state_dict(rec["start"][1], device=dev)
        bm = steps.update(new_accumulators(dev), neighbors, tpp,
                          ix.labels[rows_t],
                          torch.ones(len(rows), dtype=torch.bool,
                                     device=dev), 1.0)
        worst = 0.0
        for key in ("loss", "acc", "gn_proj", "gn_fuse", "gn_det"):
            want = float(bm[key])
            rel = abs(rec["metrics"][key] - want) / max(abs(want), 1e-12)
            worst = max(worst, rel)
            if not rel <= 1e-5:
                faults.append(f"step {i} {key}: {rec['metrics'][key]} "
                              f"against {want}")
        for (gm, gv), bn in zip(rec["bn"], model.detection_model.norms):
            for got, want in ((gm, bn.running_mean), (gv, bn.running_var)):
                if not torch.allclose(got, want.cpu(), rtol=1e-5, atol=1e-5):
                    faults.append(f"step {i}: BatchNorm running statistics "
                                  f"off by "
                                  f"{float((got - want.cpu()).abs().max()):.2e}")
        off = total = unexcused = 0
        pmax = mom = 0.0
        params = dict(model.named_parameters())
        if {n for st in opt.state.values() for n in st["mu"]} != set(params):
            faults.append(f"step {i}: Adam's groups do not cover the "
                          f"parameters")
        for group, st in opt.state.items():
            got_st = rec["adam"][group]
            for key in ("mu", "nu"):
                scale = max(float(t.abs().max()) for t in st[key].values())
                for name, t in st[key].items():
                    d = float((got_st[key][name] - t.cpu()).abs().max())
                    mom = max(mom, d / max(scale, 1e-30))
                    if not d <= 1e-4 * scale:
                        faults.append(f"step {i}: Adam {key} of {name} off "
                                      f"by {d:.2e} (group max {scale:.2e})")
            for name, mu in st["mu"].items():
                want = params[name].detach().cpu()
                diff = (rec["params"][name] - want).abs()
                pmax = max(pmax, float(diff.max()))
                bad = diff > 1e-6 + 1e-5 * want.abs()
                wmu = mu.cpu()
                near_zero = (got_st["mu"][name] - wmu).abs() > 1e-3 * wmu.abs()
                unexcused += int((bad & ~near_zero).sum())
                off += int(bad.sum())
                total += diff.numel()
        if unexcused or pmax > 2 * opt.lr + 1e-6 or off > 0.005 * total:
            faults.append(f"step {i}: parameters off the single-device "
                          f"step's ({off} of {total}, {unexcused} where "
                          f"the first moments agree, max {pmax:.2e})")
        report.append(f"step {i}: neighbors {_held_text(held)}; metrics "
                      f"within {worst:.2e} relative; Adam moments within "
                      f"{mom:.2e} of their group's largest; parameters max "
                      f"|diff| {pmax:.2e}, {off} of {total} past 1e-6 + "
                      f"1e-5 |p|, all where the first moments disagree")
    print(f"{label} against the single-device trainer from the same states "
          f"and neighbors: " + "; ".join(report))
    if faults:
        raise AssertionError(f"{label}: " + "; ".join(faults))


def mesh_phase(torch, dev, tmp: str, pipe, ref, card):
    """The mesh on torch.distributed at full width, ranks spawned on cuda:0
    (they share the card: no figure here is a scaling figure): the serving
    phase's table saved and loaded on each mesh; world 1 (NCCL, 1 x 1),
    world 2 (gloo with CUDA tensors: serving, SQ8, IVF, the refused refined
    SQ8 and the TP encoder on 1 x 2; 3 train steps and an epoch on 2 x 1),
    world 4 (2 x 2: predict_batch(64) and a train step). Every rank's
    results are held here. → {path: launches}."""
    import numpy as np

    from radad_tpu_torch.ops import _native

    _native.build()  # the ranks load the libraries built here
    vdb = os.path.join(tmp, "mesh_vdb")
    t0 = time.perf_counter()
    pipe.index.save(vdb)
    print(f"mesh phase: the {pipe.index.ntotal}-row table saved in "
          f"{time.perf_counter() - t0:.2f} s for the ranks to load")
    cfg = pipe.config
    serve_cfg = dict(data_root=os.path.join(tmp, "mesh_run"),
                     vector_db_path=vdb, train_data_path=cfg.train_data_path,
                     use_layer_norm=True, use_batch_norm=False,
                     random_seed=SEED)
    rng = np.random.default_rng(SEED + 9)
    job = dict(serve_cfg=serve_cfg, vdb=vdb,
               sets={1: ref["q_paths"][1:2], 8: ref["q_paths"][8:16],
                     64: ref["batch64"]},
               step_rows=[rng.choice(pipe.index.ntotal, MESH_STEP_B,
                                     replace=False) for _ in range(3)],
               db_paths=ref["db_paths"], q_paths=ref["q_paths"])
    by_path = {}
    for label, backend, world, cases in MESH_WORLDS:
        t0 = time.perf_counter()
        outs = _run_mesh_world(label, backend, world,
                               dict(job, cases=cases), tmp)
        secs = time.perf_counter() - t0
        print(f"mesh {label}: {backend}, {world} rank(s) on cuda:0, "
              f"{secs:.1f} s [{card}]")
        for case in cases:
            per = [o[case] for o in outs]
            res = per[0]["res"]
            print(f"  {case} on mesh {per[0]['shape'][0]}x"
                  f"{per[0]['shape'][1]}: "
                  f"{max(p['s'] for p in per):.2f} s, peak memory a rank "
                  f"{[round(p['peak_gib'], 2) for p in per]} GiB, "
                  f"collectives {per[0]['calls']}")
            if case == "probe":
                print(f"  gloo with CUDA tensors takes: {res}")
                refused = sorted(n for n, v in res.items() if v is not True)
                if refused:
                    raise AssertionError(f"gloo refused {refused} on CUDA "
                                         f"tensors, which the mesh moves")
            elif case in ("serve", "serve64"):
                for b in (8, 64):
                    if f"b{b}" not in res:
                        continue
                    for r, o in enumerate(per):
                        if o["res"][f"b{b}"]["rows"] != res[f"b{b}"]["rows"]:
                            raise AssertionError(f"{label}: rank {r}'s "
                                                 f"neighbors differ")
                    _mesh_hold_serving(torch, pipe, res[f"b{b}"],
                                       job["sets"][b],
                                       f"  {label} predict_batch({b})")
                    print(f"  {label} predict_batch({b}): median "
                          f"{float(np.median(res[f'b{b}']['ms'])):.2f} ms "
                          f"{[round(x, 2) for x in res[f'b{b}']['ms']]}, "
                          f"{res['rows_a_rank']} rows a rank [{card}]")
                print(f"  {label} predict_batch(64) collectives "
                      f"{res['calls_b64']}")
            elif case == "sq8":
                for name, rec in res.items():
                    print(f"  {label} {name}: build {rec['build_s']:.2f} s, "
                          f"{rec['rows_a_rank']} rows a rank; ids equal to "
                          f"the plain form, distances within "
                          f"{max(rec['b8_err'], rec['b64_err']):.2e}; "
                          f"against the plain form on the CPU: B=8 "
                          f"{_cpu_text(rec['b8_cpu'])}, B=64 "
                          f"{_cpu_text(rec['b64_cpu'])}; "
                          f"predict_batch median ms B=8 "
                          f"{float(np.median(rec['b8_ms'])):.2f}, B=64 "
                          f"{float(np.median(rec['b64_ms'])):.2f} [{card}]")
            elif case == "ivf":
                for r, o in enumerate(per):
                    rr = o["res"]
                    print(f"  {label} IVF rank {r}: B=64 {rr['b64']['gate']};"
                          f" B=1 {rr['b1']['gate']}; gather searches "
                          f"{rr['gather_searches']}, of them over budget "
                          f"{rr['gather_scans']}")
                print(f"  {label} IVF: built in {res['build_s']:.2f} s, ids "
                      f"equal to the plain forms, distances within "
                      f"{max(res['b64']['err'], res['b1']['err']):.2e}; "
                      f"against the plain forms on the CPU: B=64 "
                      f"{_cpu_text(res['b64']['cpu'])}, B=1 "
                      f"{_cpu_text(res['b1']['cpu'])}; "
                      f"predict(1) median "
                      f"{float(np.median(res['b1_predict_ms'])):.2f} ms, "
                      f"predict_batch(64) median "
                      f"{float(np.median(res['b64_ms'])):.2f} ms [{card}]")
            elif case == "refined":
                print(f"  {label} refined SQ8 refused: {res['raised']}")
            elif case == "tp":
                for r, o in enumerate(per):
                    rr = o["res"]
                    if rr["fused_mha"]["no_bias"] <= 0:
                        raise AssertionError(f"TP rank {r}: fused_mha not "
                                             f"launched")
                    print(f"  {label} TP rank {r}: {rr['heads_a_rank']} "
                          f"heads a rank (qw {rr['qw_rows']} rows), "
                          f"fused_mha {rr['fused_mha']}, collectives "
                          f"{rr['calls']}, max |diff| {rr['max_abs']:.3e} "
                          f"(rtol 2e-4, atol 1e-5)")
                by_path["mesh_tp"] = {"fused_mha": sum(
                    o["res"]["fused_mha"]["no_bias"]
                    + o["res"]["fused_mha"]["bias"] for o in per)}
            elif case.startswith("steps"):
                spread = max(o["res"]["param_spread"] for o in per)
                if spread != 0.0:
                    raise AssertionError(f"{label}: parameters differ "
                                         f"across ranks by {spread}")
                recs = res["steps"]
                _mesh_single_steps(torch, pipe, recs, job,
                                   f"  {label} train steps")
                ms = [s["ms"] for s in recs]
                print(f"  {label} train step at B = {MESH_STEP_B}: median "
                      f"{float(np.median(ms)):.2f} ms "
                      f"{[round(x, 2) for x in ms]}, parameters equal on "
                      f"every rank (max |delta| 0) [{card}]")
            elif case == "epoch":
                print(f"  {label} 1 epoch + evaluate at dropout 0.1: train "
                      f"loss {res['train_loss']:.4f}, val {res['val_loss']:.4f}"
                      f", evaluate {res['eval_loss']:.4f} ({res['s']:.1f} s)")
    return by_path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import radad_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import radad_tpu_torch ({e}); run from "
              f"the root of a checkout", file=sys.stderr)
        return 2
    import gc

    t_start = time.perf_counter()
    card, dev = header(torch)
    recs = kernel_phase(torch, dev)
    with tempfile.TemporaryDirectory(prefix="radad_smoke_") as tmp:
        pipe, by_path, q_paths, ref = serving_phase(torch, dev, tmp)
        server_phase(pipe, q_paths)
        # the SQ8 index (plain, residual, int4-refined) on the same table
        by_path.update(sq8_phase(torch, dev, tmp, pipe, ref))
        # the IVF index on the same table, then at capacity scale
        by_path.update(ivf_phase(torch, dev, tmp, pipe, ref, card))
        # the mesh on torch.distributed: ranks on cuda:0 load the table
        by_path.update(mesh_phase(torch, dev, tmp, pipe, ref, card))
        del pipe  # free the first pipeline before building the second
        for phase in (*(lambda m=m: ivf_capacity_phase(torch, dev, card, *m)
                        for m in IVF_CAPACITY_DATA),
                      lambda: wavlm_phase(torch, dev, tmp),
                      lambda: fused_forward_phase(
                          torch, dev, tmp, "hubert",
                          "facebook/hubert-xlarge-ls960-ft", "hubert_xlarge"),
                      lambda: _train_then_introspect(torch, dev, tmp, card),
                      # mixed precision: bf16 encoders and fusion model
                      lambda: serving_bf16_phase(torch, dev, tmp, ref),
                      lambda: wavlm_phase(torch, dev, tmp, mixed=True),
                      lambda: train_bf16_phase(torch, dev, tmp),
                      lambda: wavlm_large_bf16_phase(torch, dev, tmp)):
            gc.collect()
            torch.cuda.empty_cache()
            by_path.update(phase())
        # Whisper: whisper-base serving in both pad modes, f32 then bf16
        # with fused attention; whisper-large-v3's encoder alone
        gc.collect()
        torch.cuda.empty_cache()
        whisper_paths, whisper_ref = whisper_phase(torch, dev, tmp)
        by_path.update(whisper_paths)
        by_path.update(whisper_bf16_phase(torch, dev, tmp, whisper_ref))
        by_path.update(fused_forward_phase(torch, dev, tmp, "whisper",
                                           "openai/whisper-large-v3",
                                           "whisper_large_v3"))
    kernels = []
    for name, r in recs.items():
        per_path = {p: n.get(name, 0) for p, n in by_path.items()
                    if n.get(name, 0)}
        rec = dict(name=name, route=r["route"], source=r["source"],
                   replaces=r["replaces"], launches=sum(per_path.values()),
                   max_abs_err=r["max_abs_err"], ms=r["ms"],
                   plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                   bound_by=r["bound_by"], library_ms=r["library_ms"],
                   bound_rate=r["bound_rate"], launches_by_path=per_path,
                   **_pick(r, ("ms_source", "plain_ms_source",
                               "library_ms_source")))
        if name == "exact_dot":
            rec["launches_by_form"] = {
                form: sum(n.get(f"exact_dot_{form}", 0)
                          for n in by_path.values())
                for form in ("per_query", "split")}
            rec["launches_by_kind"] = {
                kind: sum(n.get(f"exact_dot_{kind}", 0)
                          for n in by_path.values())
                for kind in ("f32", "bf16", "int8")}
        if name == "extract_candidates":
            shapes = {}
            for n in by_path.values():
                for key, v in n.items():
                    if key.startswith("extract_candidates_T="):
                        shape = key[len("extract_candidates_"):]
                        shapes[shape] = shapes.get(shape, 0) + v
            rec["launches_by_shape"] = shapes
        if name in ("exact_dot", "extract_candidates"):
            # a launch answers only where its search was certified
            searches = {p: (by_path[p]["searches"], by_path[p]["fallbacks"])
                        for p in per_path if "searches" in by_path[p]}
            rec["searches_by_path"] = searches
            rec["route_by_path"] = {p: by_path[p]["route"]
                                    for p in searches}
            rec["launches_answering"] = sum(
                round(per_path[p] * (s - f) / s)
                for p, (s, f) in searches.items() if s)
        if "b8" in r:
            rec["kernel_ms"] = r["kernel_ms"]
            rec["b8"] = _pick(r["b8"], (
                "ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err"))
        if "no_bias" in r:
            rec["max_rel_err"] = r["max_rel_err"]
            rec["no_bias"] = _pick(r["no_bias"], (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err", "max_rel_err", "streamed_ms",
                "resident_mma_ms"))
        if "streamed_ms" in r:
            rec["streamed_ms"] = r["streamed_ms"]
            rec["launches_by_form"] = {
                form: sum(n.get(f"fused_mha_bf16_{form}", 0)
                          for n in by_path.values()) for form in BF16_FORMS}
        if "hmma" in r:
            rec["hmma"] = r["hmma"]
        if "max_bf16_steps" in r:
            rec["max_bf16_steps"] = r["max_bf16_steps"]
        for key in ("by_shape", "hd80", "whisper", "sq8_int8", "sq8",
                    "bf16_rows", "f32_body", "whisper_large_v3", "tp_rank",
                    "frontend"):
            if key in r:
                rec[key] = r[key]
        kernels.append(rec)
    print("search route by path: " + json.dumps(
        {p: n["route"] for p, n in by_path.items() if "route" in n}))
    print("IVF gather-route searches (and their fallbacks) by path: "
          + json.dumps({p: (n["gather_searches"], n["gather_fallbacks"])
                        for p, n in by_path.items()
                        if "gather_searches" in n}))
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
