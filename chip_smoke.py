#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (rag_icd10_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA kernel of the served paths from this checkout's
   sources (one nvcc per source, all started together): K1 fused_score,
   K2 slot_stream, K3/K4 chunk_max, K5 gather_rescore.
3. Kernel phase: holds each kernel against its plain PyTorch version on
   the card and times the kernel, the plain version and one library call
   computing the same function (CUDA events). K1 at the served corpus
   shape (40,474 rows padded to 40,960, D = 768) for B in {2, 8, 16, 64,
   256} and every mode, each row naming the path fused_score_plan took
   ("stream", "mma" or "tile") with its host and card times beside the
   library's; K1's threshold rows time fp32 at B in {8, 16} on "stream"
   and "tile" and a bf16 corpus on "mma" with 16- and 32-query tiles,
   each held against the plain version; K2-K5 at that shape and at
   N = 1,048,576 (rows made
   on the card from a seeded generator) for B in {8, 64, 256} and
   k in {10, 100}, K3/K4 also at B in {2, 16, 17}, K5 also at B in
   {2, 4, 16, 17, 32}. Each K3/K4 row names
   the path chunk_max_plan took ("stream", "mma" with its TFLOP/s, or
   "simt"), the host time per call and the card time with the calls
   queued behind a sleeping kernel (device_ms, beside the library's).
   The threshold rows time bf16 at B in {1, 2} on "stream" and "mma" and
   fp32 at B in {8, 16} on "stream" and "simt" (the plan's path and the
   other one forced), each held against the plain version. Each K5 row
   names the path rescore_plan took ("pairs" or "grouped"), times it on
   the card, back to back and on the host beside the library's two
   spellings (gather + bmm; dense matmul + gather of the columns), and
   times both paths forced, each held against the plain version; one
   more K5 row re-scores a batch of 64 near-identical queries (k = 100),
   whose pairs nearly all share chunks.
4. Slice phase: writes a 40,474-row synthetic ICD corpus to a CSV in a
   temporary directory and builds the store with the port's
   DatabaseBuilder (tools/build_database.py) and a full-width BERT-base
   encoder (12 layers, 768 hidden, 12 heads, 3072 intermediate, vocab
   21128, bf16, seeded random weights), printing its texts/s and
   seconds, then runs verify_database; starts the port's API server on
   127.0.0.1 over the built store (fp32 residency on the card, with
   STORE_SHARDED=on, which must serve unsharded on one card: fault F3)
   and sends /query requests: the 8 QUERIES with
   the default method (exact), then with search_method "streaming" and
   "chunkstream". Every request must answer 200 with candidates; the
   certified methods must give exact's candidates, and chunkstream must
   certify every query without a redo; each method's kernels must have
   launched during its requests; one request's batch must give the same
   top-k through the kernel as through the plain version. On the same
   rows, VectorStore.search with CHUNKSTREAM_SCAN=pallas_bf16 and
   pallas_int8 must give exact's hits and launch K3's bf16 path and K4
   (their certificate counts are printed with the epsilon of the path
   taken and that of fp32 sums); K3/K4 also run at B = 16 and 17 on
   served embeddings.
5. Every other search method and residency (the third slice): /query
   with search_method "fast" (exact's candidates, K1 launched on every
   request; certified fraction and redone batches), "sketch" and "hnsw"
   (their screen and graph built first, timed; overlap with exact's
   candidates); VectorStore.search at B in {8, 64} over the served rows
   with int8 residency (INT8_RERANK device and host), host residency,
   "sketch", "hnsw" and "fast", each with recall@k against exact and,
   where the tier scores in exact fp32, its scores held against exact;
   chunk_select_search in each scan precision (K1) and bf16_rerank_search
   (K2, exact=False, k 20 and 100) against their plain versions; the int8
   product on the card bit for bit against the CPU's int32 matmul; and
   build_sketch over the N = 1,048,576 rows on the card, its chunked
   screen against the one-scan screen.
6. Sharded phase (parallel/, the fifth slice): ShardedFlatSearcher over
   1, 2, 4 and 8 logical shards of cuda:0, over the served corpus and
   over N = 1,048,576 rows made on the card (seed 2), at B in {8, 64}
   and k in {20, 100}, for auto, exact, streaming, fast, chunkstream and
   approx (K2 per shard for auto/streaming, K1 for exact/approx/fast, K1
   + K5 for chunkstream) and int8 exact/chunkstream. Each row holds the
   merged top-k against the single-device fused_search (values within
   TOL_FP32, ids up to ties; int8 against int8_search bit for bit) and
   prints the launches of one search, the redone batches, the card's
   busy time per search (torch.profiler) and the host time; at one shard
   beside the unsharded store's spelling of the method. Then
   VectorStore(sharded="on") over 4 logical shards against the unsharded
   store (the same hits; int8 shards with exact scores, recall@k >= 0.9),
   whose searches at B = 8 are the sharded main path whose launches are
   counted; and an NCCL process group of world size 1 whose 4-shard merge
   must equal the local one.
7. Fused + NER phase (FUSED_QUERY=1, NER model mode): writes a seeded
   BERT-base token classifier (12 layers, 768 hidden, the encoder's
   vocab, the 9 labels of rag_icd10_tpu/tools/train_ner.py) with the
   port's converter functions and holds it on the card against the CPU
   on the 8 QUERIES (bf16 within 2e-2, fp32 within 1e-5 with the same
   spans); starts a server over the saved store with FUSED_QUERY=1 and
   NER_WEIGHTS_PATH set (the warmup captures the CUDA graphs) and sends
   QUERIES twice timed and once under torch.profiler, then once with
   search_method "exact" (the two-step path on the same server). Every
   request must take the fused path, one replay per coalesced batch and
   K1 once per replay, the candidates must equal the two-step path's,
   NER must run in model mode with no fallback to rules. Then
   FusedQueryEngine.query at B in {1, 8, 64} and k in {20, 100} (exact,
   approx, streaming over fp32; exact over bf16), each replay held
   against the eager two-step path with the plain kernel version and
   timed beside the same chain run eagerly.
8. Train phase (tools/train_encoder.py, parallel/train.py, the eval
   gate): full-width BERT-base (bf16 compute, fp32 parameters) on
   triplet batches that train_encoder.draw_batch makes from the
   synthetic corpus at the CLI's defaults (hard negatives, the weighted
   loss). The same seeded 3 steps at batch 8 on the card and on the CPU,
   bf16 and fp32 compute, each step's loss printed on both and held
   within TOL_TRAIN_BF16 / TOL_TRAIN_FP32; ms per step and samples/s at
   batch 256 over 20 steps after 3 (CUDA events), peak device memory,
   dense TFLOP/s and the card's busy share (torch.profiler). Then
   train_encoder.main end to end on the card (the corpus as a CSV under
   ICD_DATA_PATH, 20 steps, --eval-gate 0.0): the gate must bless the
   weights, every loss must be finite, and the gate's searches must
   launch K1 (counted from 0 just before the run); the embed, the eval
   and the whole run are timed, and the tiers printed.
9. Prints one JSON line describing each kernel (K1, K2 and K5 with their
   sharded launches and rows; K1 with its eval_gate launches), and as
   the last line {"ok": true, "device": {...}}.

Any failed check raises: the script then exits non-zero. It also exits
non-zero, printing no result, when CUDA is unavailable or when the
package is not beside it. It imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import json
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}  # fp32 outside tensor cores; bf16 dense
DEVICE = "cuda"
N_REAL, DIM = 40474, 768
TOL_FP32 = 5e-5  # sequential fp32 sums of 768 unit-vector products vs cuBLAS order
TOL_BF16_VS_FP32 = 2e-2  # bf16 residency against the exact fp32 scores
N_LARGE = 1 << 20  # the corpus scale the streaming and chunkstream methods exist for
CERTIFIED_METHODS = ("streaming", "chunkstream", "fast")
APPROX_METHODS = ("sketch", "hnsw")  # approximate selection, exact scores
TIER_K = 20  # top_k 10 with the orchestrator's over-fetch of 2

QUERIES = [  # (text, top_k): single- and multi-diagnosis, top_k 5 and 10
    ("急性胃肠炎", 5),
    ("急性胃肠炎，高血压病3级", 10),
    ("慢性肝炎", 5),
    ("疑似肺部感染，2型糖尿病", 10),
    ("慢性阻塞性肺疾病急性加重，冠状动脉粥样硬化性心脏病", 5),
    ("复发性胃溃疡", 10),
    ("急性心梗死，肾功能不全，继发性肝损伤", 5),
    ("高血压", 10),
]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 20) -> float:
    """Host time per call, not waiting for the card: where it reaches the
    card's time per call (time_ms), launching bounds the rate, not the
    kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    out = (time.perf_counter() - t) / reps * 1e3
    torch.cuda.synchronize()
    return out


def device_ms(fn, reps: int = 20) -> float:
    """Card time per call with the calls queued behind a sleeping kernel,
    so that the host's time between launches does not show (time_ms
    measures calls back to back, which is host time where that is longer)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 2e9 cycles/s is above the card's clock: the sleep outlasts the enqueue
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_split(fn, reps: int = 10) -> dict:
    """Card time per call of each kernel fn launches (torch.profiler)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key.rsplit("::", 1)[-1][:40]: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.self_device_time_total > 0}


def k1_times(fn, plain, library, reps: int = 20) -> dict:
    """K1's times: back to back (ms), on the card (device_ms), per call on
    the host (host_ms); the plain version; the library call on the card
    and back to back."""
    return {
        "ms": time_ms(fn, reps), "device_ms": device_ms(fn, reps),
        "host_ms": host_ms(fn, reps), "plain_ms": time_ms(plain, reps),
        "library_ms": time_ms(library, reps),
        "library_device_ms": device_ms(library, reps),
        "library_host_ms": host_ms(library, reps),
    }


def score_bound_ms(b: int, n: int, d: int, corpus_bytes: int, kind: str):
    """Least time for (B, D) x (N, D) -> (B, N) weighted scores: each input
    read once, the output written once, or the products at peak rate."""
    moved = b * d * 4 + n * d * corpus_bytes + 2 * n * 4 + b * n * 4
    t_bytes = moved / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * n * d / PEAK_FLOPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(weights_np):
    """K1 against its plain version at the served corpus shape; K2-K5 at
    that shape and at N_LARGE rows."""
    import numpy as np
    import torch

    from rag_icd10_tpu_torch.ops.flat_topk import pad_corpus, weighted_scores_reference
    from rag_icd10_tpu_torch.ops.fused_score import (
        fused_score_plan, fused_weighted_scores, sm_count,
    )

    rng = np.random.default_rng(1)
    c = rng.standard_normal((N_REAL, DIM), dtype=np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    cp, wp, mp = pad_corpus(c, weights_np, multiple=1024)
    dev = torch.device(DEVICE)
    corpus32 = torch.from_numpy(cp).to(dev)
    corpus16 = corpus32.to(torch.bfloat16)
    w = torch.from_numpy(wp).to(dev)
    m = torch.from_numpy(mp).to(dev)
    n = corpus32.shape[0]
    modes = {
        # mode: (corpus, exact, peak kind, corpus bytes, library call)
        "fp32_exact": (corpus32, True, "fp32", 4,
                       lambda q: torch.matmul(q, corpus32.T).mul_(w).add_(m)),
        "fp32_bf16pass": (corpus32, False, "bf16", 4,
                          lambda q: torch.matmul(q.bfloat16(), corpus32.bfloat16().T)
                          .float().mul_(w).add_(m)),
        "bf16_corpus": (corpus16, True, "bf16", 2,
                        lambda q: torch.matmul(q.bfloat16(), corpus16.T)
                        .float().mul_(w).add_(m)),
    }
    rows = []
    for b in (2, 8, 16, 64, 256):
        q_np = rng.standard_normal((b, DIM), dtype=np.float32)
        q_np /= np.linalg.norm(q_np, axis=1, keepdims=True)
        q = torch.from_numpy(q_np).to(dev)
        exact_ref = weighted_scores_reference(q, corpus32, w, m)
        for mode, (corpus, exact, kind, cbytes, library) in modes.items():
            got = fused_weighted_scores(q, corpus, w, m, exact=exact)
            want = weighted_scores_reference(q, corpus, w, m, exact=exact)
            torch.cuda.synchronize()
            check(tuple(got.shape) == (b, n) and got.dtype == torch.float32,
                  f"K1 {mode} B={b} output shape/dtype")
            check(bool(torch.isfinite(got[:, :N_REAL]).all()), f"K1 {mode} B={b} finite")
            err = (got[:, :N_REAL] - want[:, :N_REAL]).abs().max().item()
            check(err <= TOL_FP32, f"K1 {mode} B={b} max|kernel-plain|={err} > {TOL_FP32}")
            check(bool((got[:, N_REAL:] < -1e29).all()), f"K1 {mode} B={b} padding masked")
            if mode == "bf16_corpus":
                err32 = (got[:, :N_REAL] - exact_ref[:, :N_REAL]).abs().max().item()
                check(err32 <= TOL_BF16_VS_FP32,
                      f"K1 bf16 corpus B={b} vs fp32 scores {err32} > {TOL_BF16_VS_FP32}")
            bound, bound_by = score_bound_ms(b, n, DIM, cbytes, kind)
            plan = fused_score_plan(b, n, DIM, corpus.dtype, exact, sm_count(dev.index or 0))
            row = {
                "mode": mode, "B": b, "N": n, "D": DIM, "path": plan.path,
                "max_abs_err": err,
                **k1_times(lambda: fused_weighted_scores(q, corpus, w, m, exact=exact),
                           lambda: weighted_scores_reference(q, corpus, w, m, exact=exact),
                           lambda: library(q)),
                "bound_ms": bound, "bound_by": bound_by,
            }
            rows.append(row)
            print("K1 " + json.dumps(row), flush=True)
            del got, want
        del exact_ref
    gen = torch.Generator(device=dev).manual_seed(5)
    threshold = k1_threshold_rows(corpus32, corpus16, w, m, gen)
    k25 = certified_sweep(corpus32, w, m, N_REAL, seed=3, reps=10)
    del corpus16
    torch.cuda.empty_cache()
    big = large_corpus()
    large = certified_sweep(*big, N_LARGE, seed=4, reps=3)
    sketch_large = large_sketch_phase(big[0], big[1])
    del big
    torch.cuda.empty_cache()
    return rows, threshold, {name: k25[name] + large[name] for name in k25}, sketch_large


def k1_threshold_rows(corpus32, corpus16, w, m, gen, reps: int = 20):
    """K1 on both of its paths at B = 8 and 16, each passed in through
    ``plan=`` and held against the plain version, timed on the card: fp32
    on "stream" (the plan's) and "tile" (the evidence for
    SCORE_STREAM_MAX_B); a bf16 corpus on "mma" with the plan's 16-query
    tile and a 32-query tile."""
    import torch

    from rag_icd10_tpu_torch.ops.flat_topk import weighted_scores_reference
    from rag_icd10_tpu_torch.ops.fused_score import (
        ScorePlan, fused_score_plan, fused_weighted_scores, sm_count,
    )

    n, d = corpus32.shape
    sms = sm_count(corpus32.device.index or 0)
    rows = []
    for b in (8, 16):
        q = torch.randn((b, d), generator=gen, device=corpus32.device)
        q /= q.norm(dim=1, keepdim=True)
        for corpus, other in ((corpus32, ScorePlan("tile", False)),
                              (corpus16, ScorePlan("mma", True, tile_rows=32))):
            plan = fused_score_plan(b, n, d, corpus.dtype, True, sms)
            want = weighted_scores_reference(q, corpus, w, m)
            row = {"corpus": str(corpus.dtype).replace("torch.", ""), "B": b, "N": n,
                   "plan": plan.path}
            for p in (plan, other):
                name = f"{p.path}{p.tile_rows or ''}"
                got = fused_weighted_scores(q, corpus, w, m, plan=p)
                err = (got[:, :N_REAL] - want[:, :N_REAL]).abs().max().item()
                check(err <= TOL_FP32, f"K1 {row['corpus']} B={b} on {name}: |kernel-plain| {err}")
                row[f"{name}_err"] = err
                row[f"{name}_ms"] = device_ms(
                    lambda: fused_weighted_scores(q, corpus, w, m, plan=p), reps)
            rows.append(row)
            print("K1 threshold " + json.dumps(row), flush=True)
    return rows


def bound_ms(moved_bytes: float, ops: float, kind: str):
    t_bytes = moved_bytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    """max |a - b| where both are finite; inf entries must match exactly."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    check(bool((a[~fin] == b[~fin]).all()), "non-finite entries agree")
    return (a[fin] - b[fin]).abs().max().item() if bool(fin.any()) else 0.0


def k2_measure(q, corpus, w, m, k, reps):
    """K2 against its plain version at the served depth S = k over
    slot_count's ranges; its top-k against the exact one."""
    import torch

    from rag_icd10_tpu_torch.ops.flat_topk import weighted_scores_reference
    from rag_icd10_tpu_torch.ops.fused_score import (
        slot_count, streaming_candidates, streaming_candidates_reference,
        streaming_topk,
    )

    b, d = q.shape
    n = corpus.shape[0]
    S, G = k, slot_count(b, n, k)
    print(f"K2 B={b} N={n} k={k}: G={G} ranges, S={S}, {G * S} candidates per query",
          flush=True)
    vals, ids, bnd = streaming_candidates(q, corpus, w, m, S, G)
    pv, _, pb = streaming_candidates_reference(q, corpus, w, m, S, G)
    torch.cuda.synchronize()
    err = max(max_err(vals, pv), max_err(bnd, pb))
    check(err <= TOL_FP32, f"K2 B={b} N={n} k={k}: |kernel-plain| {err}")
    tv, ti, cert = streaming_topk(q, corpus, w, m, k, guarantee=False)
    check(bool(cert.all()), f"K2 B={b} N={n} k={k}: depth k certifies every query")
    exact = weighted_scores_reference(q, corpus, w, m)
    ev, _ = torch.topk(exact, k, dim=1)
    check(bool(torch.allclose(tv, ev, atol=TOL_FP32, rtol=0)),
          f"K2 B={b} N={n} k={k}: top-k values vs exact")
    picked = torch.gather(exact, 1, ti.long())
    check(bool(torch.allclose(picked, tv, atol=TOL_FP32, rtol=0)),
          f"K2 B={b} N={n} k={k}: top-k ids vs exact (up to ties)")
    del exact, pv, pb
    moved = b * d * 4 + n * d * corpus.element_size() + 2 * n * 4 + b * G * (2 * S + 1) * 4
    bound, bound_by = bound_ms(moved, 2.0 * b * n * d, "fp32")
    return {
        "B": b, "N": n, "D": d, "k": k, "S": S, "slots": G, "candidates": G * S,
        "max_abs_err": err, "certified": float(cert.float().mean()),
        "ms": time_ms(lambda: streaming_candidates(q, corpus, w, m, S, G), reps),
        "host_ms": host_ms(lambda: streaming_candidates(q, corpus, w, m, S, G), reps),
        "topk_ms": time_ms(lambda: streaming_topk(q, corpus, w, m, k, guarantee=False), reps),
        "topk_host_ms": host_ms(
            lambda: streaming_topk(q, corpus, w, m, k, guarantee=False), reps),
        "plain_ms": time_ms(
            lambda: streaming_candidates_reference(q, corpus, w, m, S, G), reps),
        "library_ms": time_ms(
            lambda: torch.topk(torch.matmul(q, corpus.T).mul_(w).add_(m), k, dim=1), reps),
        "bound_ms": bound, "bound_by": bound_by,
    }


def k34_measure(q, store, reps):
    """K3 (fp32 or bf16 store) or K4 (int8 store) against its plain
    version, on the path chunk_max_plan picks (with the TFLOP/s reached on
    "mma"). Library: one matmul (fp32, or bf16 tensor cores for the
    reduced stores) and the chunk max over the (B, N/128, 128) view."""
    import torch

    from rag_icd10_tpu_torch.ops.chunk_stream import (
        chunk_max_plan, chunk_maxima, chunk_maxima_reference,
    )

    f, sc = store.folded, store.scales
    b, d = q.shape
    n = f.shape[0]
    sms = torch.cuda.get_device_properties(f.device).multi_processor_count
    plan = chunk_max_plan(b, n, d, f.dtype, sms)
    got = chunk_maxima(q, f, sc)
    want = chunk_maxima_reference(q, f, sc)
    torch.cuda.synchronize()
    err = max_err(got, want)
    check(err <= TOL_FP32, f"chunk_max {store.scan_dtype} B={b} N={n}: |kernel-plain| {err}")
    if store.scan_dtype == "fp32":
        library = lambda: torch.matmul(q, f.T).view(b, n // 128, 128).amax(2)  # noqa: E731
    elif store.scan_dtype == "bf16":
        library = lambda: torch.matmul(q.bfloat16(), f.T).float().view(b, n // 128, 128).amax(2)  # noqa: E731
    else:
        library = lambda: (torch.matmul(q.bfloat16(), f.bfloat16().T).float() * sc).view(  # noqa: E731
            b, n // 128, 128).amax(2)
    moved = b * d * 4 + n * d * f.element_size() + b * (n // 128) * 4 + (n * 4 if sc is not None else 0)
    kind = "fp32" if store.scan_dtype == "fp32" else "bf16"
    bound, bound_by = bound_ms(moved, 2.0 * b * n * d, kind)
    row = {
        "scan": store.scan_dtype, "B": b, "N": n, "D": d, "path": plan.path,
        "max_abs_err": err,
        "ms": time_ms(lambda: chunk_maxima(q, f, sc), reps),
        "device_ms": device_ms(lambda: chunk_maxima(q, f, sc), reps),
        "host_ms": host_ms(lambda: chunk_maxima(q, f, sc), reps),
        "plain_ms": time_ms(lambda: chunk_maxima_reference(q, f, sc), reps),
        "library_ms": time_ms(library, reps),
        "library_device_ms": device_ms(library, reps),
        "bound_ms": bound, "bound_by": bound_by,
    }
    if plan.path == "mma":
        row["tflops"] = 2.0 * b * n * d / (row["device_ms"] * 1e-3) / 1e12
    print(f"K{4 if store.scan_dtype == 'int8' else 3} " + json.dumps(row), flush=True)
    return got, row


def k5_measure(q, store, cm, k, reps):
    """K5 on the chunks a chunkstream search of top-k would fetch, on the
    path rescore_plan takes, on the card (device_ms), back to back (ms)
    and on the host; then each path forced ("pairs" with the plan's group
    of rows, "grouped": <name>_ms on the card, <name>_err), each held
    against the plain version; on "grouped", each kernel's card time
    (kernels_ms: the sort's two kernels, the memset, the tiles). Library:
    the same gather plus one bmm (what the plain version does), and the
    dense route, one matmul over every row and a gather of the selected
    columns (library_dense_*)."""
    import torch

    from rag_icd10_tpu_torch.ops.chunk_stream import (
        RESCORE_TILE_ROWS, RescorePlan, gather_rescore, gather_rescore_reference,
        pairs_group_rows, rescore_plan,
    )
    from rag_icd10_tpu_torch.ops.fused_score import sm_count

    b, d = q.shape
    corpus = store.corpus
    n = corpus.shape[0]
    mc = min(max(2 * k, k + 16), cm.shape[1])
    ids = torch.topk(cm, mc, dim=1).indices.to(torch.int32)
    sms = sm_count(corpus.device.index or 0)
    plan = rescore_plan(b, mc, n // 128, d, sms)
    got = gather_rescore(q, corpus, ids)
    want = gather_rescore_reference(q, corpus, ids)
    cols = (ids.long()[:, :, None] * 128
            + torch.arange(128, device=ids.device)).reshape(b, mc * 128)
    dense = lambda: torch.gather(torch.matmul(q, corpus.T), 1, cols)  # noqa: E731
    torch.cuda.synchronize()
    err = max_err(got, want)
    check(err <= TOL_FP32, f"K5 B={b} mc={mc}: |kernel-plain| {err}")
    check(max_err(dense(), want) <= TOL_FP32, f"K5 B={b} mc={mc}: dense library route")
    distinct = int(torch.unique(ids).numel())  # chunks this batch must read
    moved = distinct * 128 * d * 4 + b * d * 4 + b * mc * 4 + b * mc * 128 * 4
    bound, bound_by = bound_ms(moved, 2.0 * b * mc * 128 * d, "fp32")
    fn = lambda: gather_rescore(q, corpus, ids)  # noqa: E731
    plain = lambda: gather_rescore_reference(q, corpus, ids)  # noqa: E731
    row = {
        "B": b, "N": n, "D": d, "k": k, "mc": mc, "distinct_chunks": distinct,
        "path": plan.path, "group_rows": plan.group_rows,
        "tile_rows": RESCORE_TILE_ROWS if plan.path == "grouped" else 0,
        "max_abs_err": err,
        "ms": time_ms(fn, reps), "device_ms": device_ms(fn, reps),
        "host_ms": host_ms(fn, reps),
        "plain_ms": time_ms(plain, reps), "library_ms": time_ms(plain, reps),
        "library_device_ms": device_ms(plain, reps),
        "library_dense_ms": time_ms(dense, reps),
        "library_dense_device_ms": device_ms(dense, reps),
        "bound_ms": bound, "bound_by": bound_by,
    }
    forced = {  # each path forced, on the card
        "pairs": RescorePlan("pairs", group_rows=pairs_group_rows(b * mc, sms)),
        "grouped": RescorePlan("grouped"),
    }
    if plan.path == "grouped":  # the sort's share of the path
        row["kernels_ms"] = kernel_split(fn)
    for name, p in forced.items():
        e = max_err(gather_rescore(q, corpus, ids, plan=p), want)
        check(e <= TOL_FP32, f"K5 B={b} mc={mc} on {name}: |kernel-plain| {e}")
        row[f"{name}_err"] = e
        row[f"{name}_ms"] = device_ms(lambda: gather_rescore(q, corpus, ids, plan=p), reps)
    print("K5 " + json.dumps(row), flush=True)
    return row


def k5_shared_row(corpus, store, n_real, gen, reps, b: int = 64, k: int = 100):
    """K5 on a coalesced batch of similar diagnoses: B queries made as one
    corpus row plus small seeded noise, so that nearly every pair hits the
    same mc chunks (the most pairs one chunk can have)."""
    import torch

    from rag_icd10_tpu_torch.ops.chunk_stream import chunk_maxima

    row = int(torch.randint(0, n_real, (1,), generator=gen, device=corpus.device))
    q = corpus[row] + 0.002 * torch.randn((b, corpus.shape[1]), generator=gen,
                                          device=corpus.device)
    q /= q.norm(dim=1, keepdim=True)
    out = k5_measure(q, store, chunk_maxima(q, store.folded), k, reps)
    out["shared_from_row"] = row
    return out


def threshold_rows(stores, gen, reps):
    """Each store at its "stream" threshold on both of its paths (the
    plan's, and the other one forced through ``plan=``), each held against
    the plain version: bf16 at B = 1 and 2 on "stream" and "mma", fp32 at
    B = 8 and 16 on "stream" and "simt"; int8 takes "mma" at every B. The
    evidence for STREAM_MAX_B."""
    import torch

    from rag_icd10_tpu_torch.ops import chunk_stream as cs

    rows = []
    some = next(iter(stores.values())).corpus
    sms = torch.cuda.get_device_properties(some.device).multi_processor_count
    for dt, other, batches in (("bf16", "mma", (1, 2)), ("fp32", "simt", (8, 16))):
        f, sc = stores[dt].folded, stores[dt].scales
        n, d = f.shape
        for b in batches:
            q = torch.randn((b, d), generator=gen, device=some.device)
            q /= q.norm(dim=1, keepdim=True)
            want = cs.chunk_maxima_reference(q, f, sc)
            plan = cs.chunk_max_plan(b, n, d, f.dtype, sms)
            row = {"scan": dt, "B": b, "N": n, "plan": plan.path}
            forced = cs.ChunkMaxPlan(other, n, tile_rows=16 if other == "mma" else 0)
            for p in (plan, forced):
                err = max_err(cs.chunk_maxima(q, f, sc, p), want)
                check(err <= TOL_FP32, f"chunk_max {dt} B={b} on {p.path}: |kernel-plain| {err}")
                row[f"{p.path}_ms"] = device_ms(lambda: cs.chunk_maxima(q, f, sc, p), reps)
            rows.append(row)
            print("K34 threshold " + json.dumps(row), flush=True)
    return rows


def certified_sweep(corpus, w, m, n_real, seed, reps):
    """K3/K4 against their plain versions for B in {2, 8, 16, 17, 64, 256}
    (both sides of the plan's threshold at 16), K2 for B in {8, 64, 256}
    and K5 for B in {2, 4, 8, 16, 17, 32, 64, 256}, each with k in {10,
    100}, and K5's shared-chunks row, over one corpus. Every K5 row also
    times each path forced (the evidence for RESCORE_GROUPED_MIN_SAVED).
    Returns {kernel: [rows]}; the rows are also in the kernels line's
    "sweep"."""
    import torch

    from rag_icd10_tpu_torch.ops.chunk_stream import build_device, chunk_maxima

    stores = {dt: build_device(corpus, w, scan_dtype=dt, n_real=n_real)
              for dt in ("fp32", "bf16", "int8")}
    gen = torch.Generator(device=corpus.device).manual_seed(seed)
    out = {"K2": [], "K3": [], "K4": [], "K5": [], "threshold": threshold_rows(stores, gen, reps)}
    for b in (2, 8, 16, 17, 64, 256):
        q = torch.randn((b, corpus.shape[1]), generator=gen, device=corpus.device)
        q /= q.norm(dim=1, keepdim=True)
        for dt in ("fp32", "bf16", "int8"):
            cm, row = k34_measure(q, stores[dt], reps)
            out["K4" if dt == "int8" else "K3"].append(row)
            if dt == "fp32":
                cm32 = cm
        for k in (10, 100):
            if b in (8, 64, 256):
                out["K2"].append(k2_measure(q, corpus, w, m, k, reps))
            out["K5"].append(k5_measure(q, stores["fp32"], cm32, k, reps))
    out["K5"].append(k5_shared_row(corpus, stores["fp32"], n_real, gen, reps))
    for b in (4, 32):  # K5 only: the rest of the batches around its threshold
        q = torch.randn((b, corpus.shape[1]), generator=gen, device=corpus.device)
        q /= q.norm(dim=1, keepdim=True)
        cm32 = chunk_maxima(q, stores["fp32"].folded)
        for k in (10, 100):
            out["K5"].append(k5_measure(q, stores["fp32"], cm32, k, reps))
    del stores
    torch.cuda.empty_cache()
    return out


def large_corpus(seed: int = 2):
    """N_LARGE unit rows, level weights and a zero mask, made on the card."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    c = torch.randn((N_LARGE, DIM), generator=gen, device=DEVICE)
    c /= c.norm(dim=1, keepdim=True)
    levels = torch.randint(0, 3, (N_LARGE,), generator=gen, device=DEVICE)
    w = torch.tensor([1.2, 1.0, 0.8], device=DEVICE)[levels]
    return c, w, torch.zeros(N_LARGE, device=DEVICE)


def recall_at_k(got_rows, want_rows) -> float:
    return statistics.mean(
        len({h.id for h in g} & {h.id for h in w}) / max(1, len(w))
        for g, w in zip(got_rows, want_rows))


def exact_score_err(store, q_np, rows) -> float:
    """max |served score - exact weighted score of the served row| (fp64)."""
    import numpy as np

    v = store._vectors
    w = store.corpus.level_weights(store.config.level_weights)
    err = 0.0
    for qi, row in zip(q_np.astype(np.float64), rows):
        for h in row:
            err = max(err, abs(h.score - float(v[h.id].astype(np.float64) @ qi) * float(w[h.id])))
    return err


def wall_ms(fn, reps: int = 5) -> float:
    """Host time per call of ``fn`` through to the card's end of it."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def tier_phase(base, queries):
    """VectorStore.search over the served rows in every residency and tier
    this slice serves, at each batch of ``queries`` ({B: tensor}) with
    k = TIER_K: int8 residency with INT8_RERANK device and host, host
    residency (the sketch screen), and on the fp32 store "sketch", "hnsw"
    and "fast". Each against "exact": recall@k, and where the tier's
    scores are exact fp32 (int8 host, host, sketch, hnsw, fast) the
    largest gap to the exact weighted score; "fast" must give exact's
    hits. Returns the rows and each store's device bytes."""
    import dataclasses

    import torch

    from rag_icd10_tpu_torch.index.vector_store import VectorStore

    tiers = {}
    memory = {"float32": base.get_memory_usage()["device_vector_bytes"]}
    for name, changes in (("int8_device", dict(device_dtype="int8", int8_rerank="device")),
                          ("int8_host", dict(device_dtype="int8", int8_rerank="host")),
                          ("host", dict(device_dtype="host"))):
        store = VectorStore(dim=DIM, config=dataclasses.replace(base.config, **changes),
                            device=DEVICE)
        store.corpus, store._vectors = base.corpus, base._vectors
        t = time.perf_counter()
        store.load_collection()
        torch.cuda.synchronize()
        print(f"tier {name}: loaded in {time.perf_counter() - t:.2f} s", flush=True)
        tiers[name] = (store, None)
        memory[name] = store.get_memory_usage()["device_vector_bytes"]
    for method in ("sketch", "hnsw", "fast"):
        tiers[method] = (base, method)
    rows = []
    for b, q in queries.items():
        q_np = q.cpu().numpy()
        exact = base.search(q, TIER_K, method="exact")
        exact_ms = wall_ms(lambda: base.search(q, TIER_K, method="exact"))
        for name, (store, method) in tiers.items():
            before = dict(store.get_collection_stats()["certificate"])
            zero_launch_counts()
            hits = store.search(q, TIER_K, method=method)
            launches = launch_counts()
            after = store.get_collection_stats()["certificate"]
            row = {"tier": name, "B": b, "k": TIER_K, "recall_at_k": recall_at_k(hits, exact),
                   "max_score_err_vs_exact": exact_score_err(base, q_np, hits),
                   "launches": {key: n for key, n in launches.items() if n},
                   "ms": wall_ms(lambda: store.search(q, TIER_K, method=method)),
                   "exact_ms": exact_ms}
            if name == "fast":
                cert = {key: after[key] - before[key] for key in after}
                row["certified_fraction"] = cert["certified"] / cert["queries"]
                row["redos"] = cert["redos"]
                check(launches["K1"] >= 1, f"fast B={b}: K1 launched {launches['K1']} times")
                for g, e in zip(hits, exact):
                    same_candidates([h.to_dict() for h in g], [h.to_dict() for h in e],
                                    f"VectorStore fast B={b} vs exact")
            if name.startswith("int8"):
                check(launches["int8_mm"] >= 1, f"{name} B={b}: the int8 product ran on the card")
            if name != "int8_device":  # the others score in exact fp32
                check(row["max_score_err_vs_exact"] <= TOL_FP32,
                      f"tier {name} B={b}: scores vs exact {row['max_score_err_vs_exact']}")
            check(all(len(r) == TIER_K for r in hits), f"tier {name} B={b}: {TIER_K} hits a row")
            rows.append(row)
            print("tier " + json.dumps(row), flush=True)
    for name, (store, _) in tiers.items():
        if store is not base:
            store.release_collection()
    torch.cuda.empty_cache()
    return rows, memory


def search_kernel_checks(store, queries):
    """K1 under chunk_select_search in each scan precision, and K2 under
    bf16_rerank_search (exact=False) at k = TIER_K and 100 (m = 200 > 128),
    over the served rows, each against its plain version (the same
    selection over the kernel's plain version), with the launches of one
    call; the int8 product on the card against the CPU's int32 matmul,
    bit for bit."""
    import torch

    from rag_icd10_tpu_torch.ops.fused_score import fused_score_plan, sm_count
    from rag_icd10_tpu_torch.ops.quantized import int8_matmul, int8_search, quantize_rows
    from rag_icd10_tpu_torch.ops.rerank import (
        bf16_rerank_search, bf16_rerank_search_reference, chunk_select_search,
        chunk_select_search_reference,
    )

    dev = store._dev
    c32, w, m = dev["corpus"], dev["weights"], dev["mask"]
    c16 = c32.to(torch.bfloat16)
    n = c32.shape[0]
    sms = sm_count(c32.device.index or 0)
    out = {"chunk_select": [], "bf16_rerank": [], "int8": []}

    def compare(name, fn, plain, row):
        zero_launch_counts()
        gv, gi, gc = fn()
        row["launches"] = launch_counts()
        pv, pi, pc = plain()
        torch.cuda.synchronize()
        row["max_abs_err"] = max_err(gv, pv)
        check(row["max_abs_err"] <= TOL_FP32, f"{name}: |kernel-plain| {row['max_abs_err']}")
        for g_v, g_i, p_v, p_i in zip(gv, gi, pv, pi):
            g = dict(zip(g_i.tolist(), g_v.tolist()))
            p = dict(zip(p_i.tolist(), p_v.tolist()))
            for j in g.keys() ^ p.keys():  # only ties at the k-th may differ
                check(abs(g.get(j, p.get(j)) - float(p_v[-1])) <= TOL_FP32, f"{name}: id {j}")
        check(torch.equal(gc, pc), f"{name}: certificates differ")
        row["certified"] = float(gc.float().mean())
        row["ms"] = time_ms(fn, 10)
        row["plain_ms"] = time_ms(plain, 10)
        print(f"{name} " + json.dumps(row), flush=True)
        return row

    for b, q in queries.items():
        for precision in ("highest", "high", "bf16"):
            scan = c16 if precision == "bf16" else c32
            kw = dict(k=TIER_K, corpus_f32=c32, scan_precision=precision, guarantee=False,
                      bound_scale=store._bound_scale)
            row = {"precision": precision, "B": b, "N": n, "D": DIM, "k": TIER_K,
                   "path": fused_score_plan(b, n, DIM, scan.dtype, True, sms).path}
            out["chunk_select"].append(compare(
                f"chunk_select {precision} B={b}",
                lambda: chunk_select_search(q, scan, w, m, **kw),
                lambda: chunk_select_search_reference(q, scan, w, m, **kw), row))
            check(row["launches"]["K1"] == 1, f"chunk_select {precision}: one K1 launch")
        for k in (TIER_K, 100):
            kw = dict(k=k, guarantee=False, bound_scale=store._bound_scale)
            row = {"B": b, "N": n, "D": DIM, "k": k, "m": max(2 * k, k + 8)}
            out["bf16_rerank"].append(compare(
                f"bf16_rerank B={b} k={k}",
                lambda: bf16_rerank_search(q, c16, c32, w, m, **kw),
                lambda: bf16_rerank_search_reference(q, c16, c32, w, m, **kw), row))
            check(row["launches"]["K2"] == 1, f"bf16_rerank k={k}: one K2 launch")
        qi, _ = quantize_rows(q)
        ci, cs = quantize_rows(c32)
        got = int8_matmul(qi, ci)
        want = int8_matmul(qi.cpu(), ci.cpu())
        check(torch.equal(got.cpu(), want), f"int8 product B={b}: card vs CPU int32")
        args = (q, ci, cs, w, m)
        gv, _ = int8_search(*args, k=TIER_K)
        cv, _ = int8_search(*(t.cpu() for t in args), k=TIER_K)
        check(torch.equal(gv.cpu(), cv), f"int8_search B={b}: card vs CPU values")
        row = {"B": b, "N": n, "D": DIM, "bit_equal": True,
               "int8_mm_ms": time_ms(lambda: int8_matmul(qi, ci), 10),
               "int8_search_ms": time_ms(lambda: int8_search(*args, k=TIER_K), 10)}
        out["int8"].append(row)
        print("int8 " + json.dumps(row), flush=True)
    del c16
    torch.cuda.empty_cache()
    return out


def fast_vs_exact_rows(store, reps: int = 20):
    """"fast"'s search (chunk_select_search over K1, as the store runs it)
    against "exact"'s (K1 + torch.topk over every column) on the served
    rows at B in {2, 8, 64, 256}, k = TIER_K: card time (device_ms) and
    host time per call. Both run the same K1 scan; "fast" replaces one
    top-k over N columns by chunk maxima, a top-k over N / 128 and one
    over the fetched mc * 128 columns."""
    import torch

    from rag_icd10_tpu_torch.ops.fused_score import fused_search
    from rag_icd10_tpu_torch.ops.rerank import chunk_select_search

    dev = store._dev
    c, w, m = dev["corpus"], dev["weights"], dev["mask"]
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    rows = []
    for b in (2, 8, 64, 256):
        q = torch.randn((b, DIM), generator=gen, device=DEVICE)
        q /= q.norm(dim=1, keepdim=True)
        fast = lambda: chunk_select_search(  # noqa: E731
            q, c, w, m, k=TIER_K, scan_precision="high", guarantee=False,
            bound_scale=store._bound_scale)
        exact = lambda: fused_search(q, c, w, m, k=TIER_K)  # noqa: E731
        fv, _, cert = fast()
        ev, _ = exact()
        torch.cuda.synchronize()
        certified = cert.nonzero().flatten()
        check(bool(torch.equal(fv[certified], ev[certified])),
              f"fast B={b}: certified values vs exact")
        row = {"B": b, "k": TIER_K, "certified": float(cert.float().mean()),
               "fast_device_ms": device_ms(fast, reps), "exact_device_ms": device_ms(exact, reps),
               "fast_host_ms": host_ms(fast, reps), "exact_host_ms": host_ms(exact, reps)}
        rows.append(row)
        print("fast vs exact " + json.dumps(row), flush=True)
    return rows


def large_sketch_phase(c, w, reps: int = 5):
    """build_sketch over the N_LARGE rows on the card (a JL basis: data-free;
    the screen chunked, 65536 rows a step) and the same rows screened in
    one scan: the chunked screen's top-m must be the one-scan screen's,
    values bit for bit, ids up to ties at the m-th."""
    import torch

    from rag_icd10_tpu_torch.ops.sketch import build_sketch, sketch_screen_scores

    torch.cuda.synchronize()
    t = time.perf_counter()
    chunked = build_sketch(c, w, d_sketch=128, kind="random", device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    check(chunked.screen_chunk == 65536, f"screen chunk {chunked.screen_chunk}")
    flat = build_sketch(c, w, proj=chunked.proj, screen_chunk=0, device=DEVICE)
    check(torch.equal(flat.sketch_q, chunked.sketch_q), "one projection, one sketch")
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    m = max(8 * TIER_K, 64)  # sketch_search_host_rerank's fetch at k = TIER_K
    rows = []
    for b in (8, 64):
        q = torch.randn((b, DIM), generator=gen, device=DEVICE)
        q /= q.norm(dim=1, keepdim=True)
        cv, ci = sketch_screen_scores(chunked, q, m)
        fv, fi = sketch_screen_scores(flat, q, m)
        torch.cuda.synchronize()
        check(torch.equal(cv, fv), f"1M sketch B={b}: chunked screen values vs one scan")
        differ = 0
        for c_v, c_i, f_i in zip(cv, ci, fi):
            for j in set(c_i.tolist()) ^ set(f_i.tolist()):
                differ += 1
                check(bool((c_v == c_v[-1]).sum() > 1), f"1M sketch B={b}: id {j} not a tie")
        row = {"N": N_LARGE, "d_sketch": chunked.d_sketch, "B": b, "m": m,
               "screen_chunk": chunked.screen_chunk, "ids_differing_on_ties": differ,
               "device_bytes": chunked.device_bytes, "fp32_rows_bytes": N_LARGE * DIM * 4,
               "build_s": build_s,
               "chunked_ms": time_ms(lambda: sketch_screen_scores(chunked, q, m), reps),
               "one_scan_ms": time_ms(lambda: sketch_screen_scores(flat, q, m), reps)}
        rows.append(row)
        print("sketch 1M " + json.dumps(row), flush=True)
    del chunked, flat
    torch.cuda.empty_cache()
    return rows


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_counts():
    from rag_icd10_tpu_torch.ops import chunk_stream, fused_score, quantized

    return {
        "K1": fused_score.fused_weighted_scores.launches,
        "K2": fused_score.streaming_candidates.launches,
        "K3": chunk_stream.chunk_maxima.launches,
        "K4": chunk_stream.chunk_maxima.launches_int8,
        "K5": chunk_stream.gather_rescore.launches,
        "int8_mm": quantized.int8_matmul.launches,  # the library's, not a kernel of ours
    }


def zero_launch_counts():
    from rag_icd10_tpu_torch.ops import chunk_stream, fused_score, quantized

    fused_score.fused_weighted_scores.launches = 0
    fused_score.streaming_candidates.launches = 0
    chunk_stream.chunk_maxima.launches = 0
    chunk_stream.chunk_maxima.launches_int8 = 0
    chunk_stream.gather_rescore.launches = 0
    quantized.int8_matmul.launches = 0


async def serve_and_query(cfg, engine_probe):
    """Start the port's API server, send QUERIES three times (two timed
    passes, then one under torch.profiler), then twice with each certified
    search method (streaming, chunkstream, fast) and each approximate one
    (sketch, hnsw; their screen and graph built first, timed), read
    /stats, stop it. Returns (latencies_ms, launches, responses, stages,
    device, certified), where ``certified`` holds each method's
    latencies, responses, launch counts and certificate counts."""
    import aiohttp
    import torch
    from aiohttp import web

    from rag_icd10_tpu_torch.api.app import APIServer
    from rag_icd10_tpu_torch.ops.fused_score import fused_weighted_scores
    from rag_icd10_tpu_torch.utils.metrics import metrics

    server = APIServer(config=cfg, device=DEVICE)
    runner = web.AppRunner(server.app)
    t0 = time.perf_counter()
    await runner.setup()  # runs Engine.startup: load store, encoder, warmup
    site = web.TCPSite(runner, cfg.api.host, cfg.api.port)
    await site.start()
    print(f"server up in {time.perf_counter() - t0:.1f} s (load + warmup)", flush=True)
    url = f"http://{cfg.api.host}:{cfg.api.port}"
    latencies, responses = [], []

    async def query_pass(session, timed: bool, method=None, lat=latencies, out=responses):
        for text, top_k in QUERIES:
            payload = {"text": text, "top_k": top_k}
            if method:
                payload["search_method"] = method
            t = time.perf_counter()
            async with session.post(url + "/query", json=payload) as resp:
                body = await resp.json()
                status = resp.status
            if timed:
                lat.append((time.perf_counter() - t) * 1e3)
            out.append((text, top_k, status, body))

    try:
        async with aiohttp.ClientSession() as session:
            async with session.get(url + "/health") as resp:
                health = await resp.json()
                check(resp.status == 200 and health["status"] == "healthy",
                      f"/health: {resp.status} {health}")
            fused_weighted_scores.launches = 0  # count the main path only
            metrics.reset()  # stage timings of these requests, not of warmup
            await query_pass(session, timed=True)
            await query_pass(session, timed=True)
            async with session.get(url + "/stats") as resp:
                stages = (await resp.json())["stage_latency"]
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t = time.perf_counter()
                await query_pass(session, timed=False)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
            launches = fused_weighted_scores.launches
            certified = {}
            store = server.engine.store
            for method in CERTIFIED_METHODS + APPROX_METHODS:
                before = dict(store.get_collection_stats()["certificate"])
                run = {"latencies": [], "responses": []}
                if method in APPROX_METHODS:  # build outside the timed requests
                    t = time.perf_counter()
                    store.build_hnsw() if method == "hnsw" else store._ensure_sketch()
                    run["build_s"] = time.perf_counter() - t
                zero_launch_counts()  # this method's requests only
                for _ in range(2):
                    await query_pass(session, True, method, run["latencies"], run["responses"])
                run["launches"] = launch_counts()
                after = store.get_collection_stats()["certificate"]
                run["certificate"] = {key: after[key] - before[key] for key in after}
                certified[method] = run
        engine_probe(server.engine)
    finally:
        await runner.cleanup()
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(ms for _, ms, _ in kernels)
    device = {
        "requests": len(QUERIES), "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "k1_ms": sum(ms for key, ms, _ in kernels if "fused_score" in key),
        "top": [{"kernel": key[:80], "ms": ms, "count": n} for key, ms, n in kernels[:8]],
    }
    return latencies, launches, responses, stages, device, certified


def same_candidates(got, want, what):
    """Same codes (up to ties at equal scores) and scores within TOL_FP32."""
    check(len(got) == len(want), f"{what}: {len(got)} vs {len(want)} candidates")
    for g, e in zip(got, want):
        check(abs(g["score"] - e["score"]) <= TOL_FP32, f"{what}: scores {g} vs {e}")
        check(g["code"] == e["code"] or abs(g["score"] - e["score"]) <= TOL_FP32,
              f"{what}: codes {g['code']} vs {e['code']}")


def reduced_scan_stores(engine, queries_dev, k):
    """VectorStore.search with CHUNKSTREAM_SCAN=pallas_bf16 and pallas_int8
    over the served rows must give the exact store's hits; returns the
    launch counts of those searches and each store's chunk store."""
    import dataclasses

    import torch

    from rag_icd10_tpu_torch.index.vector_store import VectorStore
    from rag_icd10_tpu_torch.ops.chunk_stream import certificate_eps, chunk_max_plan

    exact = engine.store.search(queries_dev, k, method="exact")
    out = {}
    for scan in ("pallas_bf16", "pallas_int8"):
        cfg = dataclasses.replace(engine.store.config, chunkstream_scan=scan)
        store = VectorStore(dim=DIM, config=cfg, device=DEVICE)
        store.corpus = engine.store.corpus
        store._vectors = engine.store._vectors
        store.load_collection()
        zero_launch_counts()
        hits = store.search(queries_dev, k, method="chunkstream")
        counts = launch_counts()
        for got_row, want_row in zip(hits, exact):
            same_candidates([h.to_dict() for h in got_row], [h.to_dict() for h in want_row],
                            f"VectorStore chunkstream {scan}")
        cs = store._chunkstore
        sms = torch.cuda.get_device_properties(cs.folded.device).multi_processor_count
        path = chunk_max_plan(len(queries_dev), *cs.folded.shape, cs.folded.dtype, sms).path
        eps = {p: certificate_eps(cs.folded.dtype, "pallas", p, cs.resid_max, cs.bound_scale,
                                  cs.folded.shape[1])
               for p in (path, "stream")}
        out[scan] = {"launches": counts, "store": cs,
                     "certificate": store.get_collection_stats()["certificate"],
                     "resid_max": cs.resid_max, "bound_scale": cs.bound_scale,
                     "path": path, "eps": eps[path], "eps_fp32_sums": eps["stream"]}
    return out


def build_store(corpus, enc_cfg, store_cfg, probe_texts):
    """The served store through the port's store builder: the corpus
    written to a CSV in a temporary directory, then
    ``DatabaseBuilder.build_full_database`` with the full-width BERT-base
    bf16 encoder (seeded random weights), then ``verify_database``.
    Returns the builder encoder's embeddings of ``probe_texts`` (to hold the
    serving encoder against) and the build row."""
    import csv
    import tempfile

    import numpy as np
    import torch

    from rag_icd10_tpu_torch import config as tconfig
    from rag_icd10_tpu_torch.index.vector_store import VectorStore
    from rag_icd10_tpu_torch.tools.build_database import DatabaseBuilder, embed_sorted

    db = store_cfg.db_path
    for suffix in (".npz", ".meta.json", ".manifest.json", ".vocab.txt", ".encoder.json"):
        Path(db + suffix).unlink(missing_ok=True)
    builder = DatabaseBuilder(tconfig.Config(encoder=enc_cfg, store=store_cfg, data_path=None),
                              device=DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = str(Path(tmp) / "icd10.csv")
        with open(csv_path, "w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerow(["code", "disease"])
            writer.writerows(zip(corpus.codes, corpus.titles))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(builder.build_full_database(csv_path, rebuild=True),
              "DatabaseBuilder built the store and its verification search answered")
        build_s = time.perf_counter() - t0
    check(embed_sorted.failed_batches == 0,
          f"{embed_sorted.failed_batches} batches failed to embed")
    arch = builder.encoder.arch
    check((arch.num_layers, arch.hidden_size, arch.num_heads, arch.intermediate_size,
           arch.vocab_size, arch.compute_dtype) == (12, 768, 12, 3072, 21128, torch.bfloat16),
          f"full-width BERT-base encoder, got {arch}")
    t = time.perf_counter()
    check(builder.verify_database(), "verify_database on the saved store")
    verify_s = time.perf_counter() - t
    store = VectorStore.load(db, config=store_cfg, device=DEVICE)
    vecs = store._vectors
    check(store.corpus.codes == corpus.codes and store.corpus.semantic_texts
          == corpus.semantic_texts, "the CSV round trip keeps the corpus")
    check(vecs.shape == (N_REAL, DIM) and bool(np.isfinite(vecs).all()), "corpus vectors")
    check(bool(np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-3)), "unit vectors")
    for suffix in (".vocab.txt", ".encoder.json", ".manifest.json"):
        check(Path(db + suffix).exists(), f"the builder wrote {suffix}")
    probe = builder.encoder.encode_queries(probe_texts)
    row = {"rows": N_REAL, "build_s": build_s, "texts_per_s": N_REAL / build_s,
           "verify_s": verify_s, "failed_batches": embed_sorted.failed_batches,
           "vocab": builder.encoder.tokenizer.vocab_size}
    print("builder " + json.dumps(row), flush=True)
    del builder, store
    torch.cuda.empty_cache()
    return probe, row


def slice_phase(corpus):
    import numpy as np
    import torch

    from rag_icd10_tpu_torch import config as tconfig
    from rag_icd10_tpu_torch.ops.flat_topk import weighted_scores_reference
    from rag_icd10_tpu_torch.ops.fused_score import (
        fused_score_plan, fused_search, fused_weighted_scores, sm_count,
    )
    from rag_icd10_tpu_torch.ops.rerank import bf16_rerank_search

    db_dir = ROOT / "build" / "chip_smoke"
    db_dir.mkdir(parents=True, exist_ok=True)
    enc_cfg = tconfig.EncoderConfig(weights_path=None, vocab_path=None)
    # F3: STORE_SHARDED=on with one card serves from that card, unsharded
    store_cfg = tconfig.StoreConfig(
        db_path=str(db_dir / "icd10_store"), search_method="exact",
        device_dtype="float32", index_type="FLAT", sharded="on", mode="local",
    )
    probe_texts = [corpus.semantic_texts[i] for i in (0, 17, N_REAL - 1)]
    build_vecs, builder_row = build_store(corpus, enc_cfg, store_cfg, probe_texts)

    cfg = tconfig.Config(
        encoder=enc_cfg,
        store=store_cfg,
        api=tconfig.APIConfig(host="127.0.0.1", port=free_port()),
    )
    found = {}

    def probe(engine):
        """After the requests: pairing, one batch through kernel vs plain,
        encoder forward time and K1 at the main path's shape."""
        served = engine.encoder.encode_queries(probe_texts)
        check(bool(np.allclose(served, build_vecs, atol=1e-5)),
              "serving encoder reproduces the store's encoder")
        mem = engine.store.get_memory_usage()
        check(engine.store.config.sharded == "on" and not mem["sharded"]
              and engine.store._dev is not None,
              f"F3: STORE_SHARDED=on on one card serves unsharded ({mem['sharded']})")
        found["f3"] = {"store_sharded": engine.store.config.sharded,
                       "memory_sharded": mem["sharded"]}
        state = engine.matcher.extract_stage([QUERIES[1][0]])
        texts = state["flat_diagnoses"]
        q = engine.encoder.encode_queries_device(texts)
        dev = engine.store._dev
        corpus_t, w, m = dev["corpus"], dev["weights"], dev["mask"]
        k = QUERIES[1][1] * engine.config.pipeline.overfetch
        vals, idx = fused_search(q, corpus_t, w, m, k=k)
        plain = weighted_scores_reference(q, corpus_t, w, m)
        pvals, _ = torch.topk(plain, k, dim=1)
        check(bool(torch.allclose(vals, pvals, atol=TOL_FP32, rtol=0)),
              "batch top-k values: kernel vs plain")
        picked = torch.gather(plain, 1, idx.long())
        check(bool(torch.allclose(picked, vals, atol=TOL_FP32, rtol=0)),
              "batch top-k ids: kernel vs plain (up to ties)")
        scores = fused_weighted_scores(q, corpus_t, w, m)
        torch.cuda.synchronize()
        b, n = q.shape[0], corpus_t.shape[0]
        bound, bound_by = score_bound_ms(b, n, DIM, 4, "fp32")
        found["main"] = {
            "B": b, "N": n, "D": DIM,
            "path": fused_score_plan(b, n, DIM, corpus_t.dtype, True,
                                     sm_count(corpus_t.device.index or 0)).path,
            "max_abs_err": (scores[:, :N_REAL] - plain[:, :N_REAL]).abs().max().item(),
            **k1_times(lambda: fused_weighted_scores(q, corpus_t, w, m),
                       lambda: weighted_scores_reference(q, corpus_t, w, m),
                       lambda: torch.matmul(q, corpus_t.T).mul_(w).add_(m)),
            "bound_ms": bound, "bound_by": bound_by,
        }
        batch8 = [t for t, _ in QUERIES]
        found["encode_ms"] = time_ms(
            lambda: engine.encoder.encode_queries_device(batch8), reps=10)
        # K2-K5 at the main path's shape: this request's batch and k
        found["K2"] = k2_measure(q, corpus_t, w, m, k, reps=20)
        fp32_store = engine.store._chunkstore  # built by the chunkstream requests
        check(fp32_store is not None and fp32_store.scan_dtype == "fp32",
              "the chunkstream requests built an fp32 chunk store")
        cm, found["K3"] = k34_measure(q, fp32_store, reps=20)
        found["K5"] = k5_measure(q, fp32_store, cm, k, reps=20)
        reduced = reduced_scan_stores(engine, engine.encoder.encode_queries_device(batch8), k)
        found["reduced"] = {scan: {key: r[key] for key in
                                   ("launches", "certificate", "resid_max", "bound_scale",
                                    "path", "eps", "eps_fp32_sums")}
                            for scan, r in reduced.items()}
        _, found["K3_bf16"] = k34_measure(q, reduced["pallas_bf16"]["store"], reps=20)
        _, found["K4"] = k34_measure(q, reduced["pallas_int8"]["store"], reps=20)
        # both sides of the plan's threshold (16) on served embeddings
        q17 = engine.encoder.encode_queries_device(corpus.semantic_texts[:17])
        found["batches"] = {"K3": [], "K4": []}
        for b in (16, 17):
            for cs in (fp32_store, reduced["pallas_bf16"]["store"],
                       reduced["pallas_int8"]["store"]):
                _, row = k34_measure(q17[:b], cs, reps=20)
                found["batches"]["K4" if cs.scan_dtype == "int8" else "K3"].append(row)
        # this slice: every residency and tier through VectorStore.search,
        # and K1/K2 on their new paths against their plain versions
        titles = corpus.titles[:: N_REAL // 64][:64]
        tier_queries = {8: engine.encoder.encode_queries_device(batch8),
                        64: engine.encoder.encode_queries_device(titles)}
        found["queries"] = tier_queries  # the sharded phase's store checks
        found["tiers"], found["tier_memory"] = tier_phase(engine.store, tier_queries)
        found["search_checks"] = search_kernel_checks(
            engine.store, {q.shape[0]: q, **tier_queries})
        found["fast_vs_exact"] = fast_vs_exact_rows(engine.store)
        zero_launch_counts()  # bf16_rerank_search once at the main shape
        bf16_rerank_search(q, corpus_t.to(torch.bfloat16), corpus_t, w, m, k=k,
                           bound_scale=engine.store._bound_scale)
        found["bf16_rerank_launches"] = launch_counts()["K2"]

    latencies, launches, responses, stages, device, certified = asyncio.run(
        serve_and_query(cfg, probe))
    for text, top_k, status, body in responses:
        check(status == 200, f"/query {text!r}: {status} {body}")
        cands = body["candidates"]
        check(1 <= len(cands) <= top_k, f"/query {text!r}: {len(cands)} candidates")
        check(all(np.isfinite(c["score"]) for c in cands), f"/query {text!r}: scores")
        if "，" in text:
            check(body["is_multi_diagnosis"], f"/query {text!r}: multi-diagnosis")
    check(launches >= len(responses),
          f"K1 launched {launches} times during {len(responses)} /query requests")
    check(device["k1_ms"] > 0, "the profiled /query requests ran K1 on the device")
    p50 = statistics.median(latencies)
    print(f"/query: {len(responses)} requests, K1 launches {launches}; timed "
          f"{len(latencies)}: p50 {p50:.2f} ms, max {max(latencies):.2f} ms", flush=True)
    print(f"encoder forward (8 queries, BERT-base bf16): {found['encode_ms']:.3f} ms",
          flush=True)
    print("stages " + json.dumps(stages), flush=True)
    print("device " + json.dumps(device), flush=True)
    print("K1 main path " + json.dumps(found["main"]), flush=True)
    e2e = {"query_p50_ms": p50, "query_max_ms": max(latencies),
           "encode_ms": found["encode_ms"], "idle_share": device["idle_share"],
           "builder": builder_row, "f3": found["f3"]}
    print("F3 STORE_SHARDED=on on one card: " + json.dumps(found["f3"]), flush=True)

    exact_by_query = {(text, top_k): body for text, top_k, _, body in responses[: len(QUERIES)]}
    main = {"K1": dict(found["main"], launches=launches)}
    for method, run in certified.items():
        for text, top_k, status, body in run["responses"]:
            check(status == 200, f"/query {method} {text!r}: {status} {body}")
            cands = body["candidates"]
            if method in APPROX_METHODS:
                check(1 <= len(cands) <= top_k and all(np.isfinite(c["score"]) for c in cands),
                      f"/query {method} {text!r}: {len(cands)} candidates")
            else:
                same_candidates(cands, exact_by_query[(text, top_k)]["candidates"],
                                f"/query {method} {text!r} vs exact")
        if method in APPROX_METHODS:
            # selection approximate, scores exact: the overlap of the
            # served candidates' codes with exact's
            overlap = []
            for text, top_k, _, body in run["responses"]:
                want = {c["code"] for c in exact_by_query[(text, top_k)]["candidates"]}
                got = {c["code"] for c in body["candidates"]}
                overlap.append(len(got & want) / max(1, len(want)))
            p50m = statistics.median(run["latencies"])
            print(f"/query {method}: {len(run['responses'])} requests, p50 {p50m:.2f} ms, "
                  f"max {max(run['latencies']):.2f} ms; built in {run['build_s']:.2f} s; "
                  f"candidate overlap with exact {statistics.mean(overlap):.4f}", flush=True)
            e2e[f"{method}_p50_ms"] = p50m
            e2e[f"{method}_max_ms"] = max(run["latencies"])
            e2e[f"{method}_build_s"] = run["build_s"]
            e2e[f"{method}_overlap_with_exact"] = statistics.mean(overlap)
            continue
        cert = run["certificate"]
        check(cert["queries"] > 0, f"{method}: the store certified no query")
        if method == "chunkstream":
            check(cert["certified"] == cert["queries"] and cert["redos"] == 0,
                  f"chunkstream certified {cert['certified']}/{cert['queries']}, "
                  f"{cert['redos']} batches redone")
        p50m = statistics.median(run["latencies"])
        print(f"/query {method}: {len(run['responses'])} requests, p50 {p50m:.2f} ms, "
              f"max {max(run['latencies']):.2f} ms; certified {cert['certified']}/"
              f"{cert['queries']} queries ({cert['certified'] / cert['queries']:.4f}), "
              f"redone batches {cert['redos']}; launches {json.dumps(run['launches'])}",
              flush=True)
        e2e[f"{method}_p50_ms"] = p50m
        e2e[f"{method}_max_ms"] = max(run["latencies"])
        e2e[f"{method}_certified_fraction"] = cert["certified"] / cert["queries"]
        e2e[f"{method}_redos"] = cert["redos"]
        if method == "fast":
            k1 = run["launches"]["K1"]
            n_req = len(run["responses"])
            check(k1 >= n_req, f"fast: K1 launched {k1} times in {n_req} requests")
            print(f"/query fast: K1 launches per request {k1 / n_req:.3f}", flush=True)
            e2e["fast_k1_launches_per_request"] = k1 / n_req
    counts = {"K2": certified["streaming"]["launches"]["K2"],
              "K3": certified["chunkstream"]["launches"]["K3"],
              "K5": certified["chunkstream"]["launches"]["K5"]}
    reduced = found["reduced"]
    check(reduced["pallas_bf16"]["launches"]["K3"] > 0, "K3's bf16 path launched")
    counts["K4"] = reduced["pallas_int8"]["launches"]["K4"]
    for name, count in counts.items():
        check(count > 0, f"{name} launched {count} times on its main path")
    for scan, r in reduced.items():
        print(f"VectorStore chunkstream {scan}: " + json.dumps(r), flush=True)
    for name in ("K2", "K3", "K4", "K5"):
        main[name] = dict(found[name], launches=counts[name])
    main["K3"]["bf16"] = found["K3_bf16"]
    for name in ("K3", "K4"):
        main[name]["batches"] = found["batches"][name]
    for name in ("K2", "K3", "K4", "K5"):
        print(f"{name} main path " + json.dumps(main[name]), flush=True)
    # this slice's paths: K1 under "fast" (its /query requests) and
    # chunk_select_search; K2 under bf16_rerank_search (no store method
    # calls it: one call at the main shape)
    check(found["bf16_rerank_launches"] == 1, "bf16_rerank_search launched K2")
    main["K1"]["launches_by_path"] = {"exact": launches,
                                      "fast": certified["fast"]["launches"]["K1"]}
    main["K1"]["chunk_select"] = found["search_checks"]["chunk_select"]
    main["K2"]["launches_by_path"] = {"streaming": counts["K2"],
                                      "bf16_rerank": found["bf16_rerank_launches"]}
    main["K2"]["bf16_rerank"] = found["search_checks"]["bf16_rerank"]
    print("int8 product " + json.dumps(found["search_checks"]["int8"]), flush=True)
    print("tier memory " + json.dumps(found["tier_memory"]), flush=True)
    e2e["fast_vs_exact"] = found["fast_vs_exact"]
    e2e["tiers"] = {f"{r['tier']}_B{r['B']}": {key: r[key] for key in
                    ("recall_at_k", "max_score_err_vs_exact", "ms", "exact_ms")}
                    for r in found["tiers"]}
    return main, e2e, cfg, stages, found["queries"]


# ---------------------------------------------------------------------------
# Sharded phase (parallel/, STORE_SHARDED): ShardedFlatSearcher over logical
# shards of cuda:0, the sharded store, and an NCCL group of world size 1.
# ---------------------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4, 8)
SHARD_BATCHES = (8, 64)
SHARD_KS = (20, 100)
SHARD_METHODS = {"fp32": ("auto", "exact", "streaming", "fast", "chunkstream", "approx"),
                 "int8": ("exact", "chunkstream")}
#: (K1, K2, K5) launches per shard of one fp32 search before any redo; a
#: redone batch adds one K1 scan ("fast" at most one per shard)
SHARD_LAUNCHES = {"auto": (0, 1, 0), "streaming": (0, 1, 0), "exact": (1, 0, 0),
                  "approx": (1, 0, 0), "fast": (1, 0, 0), "chunkstream": (1, 0, 1)}


def card_busy_ms(fn, reps: int = 3):
    """Card busy time per call: the device time of every kernel ``fn``
    launches (torch.profiler), whatever the host does between them; the
    sharded methods read their certificates with a host sync, which would
    stall calls queued behind a sleeping kernel (device_ms). A trace with
    no kernel in it is taken again, twice at most; then None (not
    measured)."""
    for _ in range(3):
        total = sum(kernel_split(fn, reps).values())
        if total > 0:
            return total
    return None


def shard_row(name, searcher, method, q, k, want, unsharded, n_real, reps):
    """One searcher search against its single-device answer, with the
    kernel launches of that search, its redone batches and its times."""
    import torch

    from rag_icd10_tpu_torch.ops import fused_score

    ns = searcher.mesh.shape["shard"]
    b = q.shape[0]
    what = f"sharded {name} {searcher.store_dtype} {method} shards={ns} B={b} k={k}"
    redos = searcher.redos + fused_score.streaming_topk.redos
    zero_launch_counts()
    vals, idx = searcher.search_device(q, k, method)
    torch.cuda.synchronize()
    counts = launch_counts()
    redone = searcher.redos + fused_score.streaming_topk.redos - redos
    check(int(idx.max()) < n_real, f"{what}: a padding row was returned")
    # int8 sums are exact: bit for bit against the int8 law
    tol = 0.0 if searcher.store_dtype == "int8" else TOL_FP32
    err = same_up_to_ties(vals.cpu().numpy(), idx.cpu().numpy(), want[0].cpu().numpy(),
                          want[1].cpu().numpy(), what, tol)
    if searcher.store_dtype == "int8":
        check(counts["int8_mm"] == ns and counts["K1"] == counts["K2"] == counts["K5"] == 0,
              f"{what}: launches {counts}")
    else:
        e1, e2, e5 = (x * ns for x in SHARD_LAUNCHES[method])
        k1_ok = e1 <= counts["K1"] <= 2 * e1 if method == "fast" else counts["K1"] == e1 + redone
        check(k1_ok and counts["K2"] == e2 and counts["K5"] == e5,
              f"{what}: launches {counts}, {redone} redone")
    fn = lambda: searcher.search_device(q, k, method)  # noqa: E731
    row = {"corpus": name, "store": searcher.store_dtype, "method": method, "shards": ns,
           "B": b, "k": k, "launches": {key: n for key, n in counts.items() if n},
           "redone": redone, "max_abs_err": err, "device_ms": card_busy_ms(fn),
           "host_ms": wall_ms(fn, reps)}
    if ns == 1:  # beside the unsharded store's spelling of the method
        row["unsharded_device_ms"] = card_busy_ms(lambda: unsharded(q, k))
        row["unsharded_host_ms"] = wall_ms(lambda: unsharded(q, k), reps)
    print("sharded " + json.dumps(row), flush=True)
    return row


def sharded_rows(name, c, w, gen, reps):
    """ShardedFlatSearcher over ``c`` (N, DIM) on the card split into
    SHARD_COUNTS logical shards of cuda:0, for every method, batch and k,
    each against the single-device answer: fp32 methods against
    ``fused_search`` (values within TOL_FP32, ids up to ties), int8 ones
    against ``int8_search`` (bit for bit)."""
    import torch

    from rag_icd10_tpu_torch.ops import chunk_stream
    from rag_icd10_tpu_torch.ops.fused_score import fused_search, streaming_topk
    from rag_icd10_tpu_torch.ops.quantized import int8_search, quantize_rows
    from rag_icd10_tpu_torch.ops.rerank import chunk_select_search
    from rag_icd10_tpu_torch.parallel import ShardedFlatSearcher, make_mesh

    dev = c.device
    n = c.shape[0]
    n_pad = -(-n // 1024) * 1024  # the searcher's padding at 8 shards and fewer
    cp = torch.nn.functional.pad(c, (0, 0, 0, n_pad - n))
    wp = torch.nn.functional.pad(w, (0, n_pad - n))
    mp = torch.zeros_like(wp)
    mp[n:] = -1e30
    c8, cs = quantize_rows(cp)
    cstore = chunk_stream.build_device(cp, wp, n_real=n)
    bound = float(wp.max()) * float(cp.norm(dim=1).max())
    unsharded = {
        "auto": lambda q, k: streaming_topk(q, cp, wp, mp, k)[:2],
        "streaming": lambda q, k: streaming_topk(q, cp, wp, mp, k)[:2],
        "exact": lambda q, k: fused_search(q, cp, wp, mp, k),
        "approx": lambda q, k: fused_search(q, cp, wp, mp, k, method="approx"),
        "fast": lambda q, k: chunk_select_search(q, cp, wp, mp, k, scan_precision="high",
                                                 bound_scale=bound)[:2],
        "chunkstream": lambda q, k: chunk_stream.search(cstore, q, k, guarantee=True)[:2],
        "int8": lambda q, k: int8_search(q, c8, cs, wp, mp, k),
    }
    queries = {}
    for b in SHARD_BATCHES:
        q = torch.randn((b, DIM), generator=gen, device=dev)
        queries[b] = q / q.norm(dim=1, keepdim=True)
    want = {(b, k): {"fp32": fused_search(q, cp, wp, mp, k), "int8": int8_search(
        q, c8, cs, wp, mp, k)} for b, q in queries.items() for k in SHARD_KS}
    rows = []
    for ns in SHARD_COUNTS:
        mesh = make_mesh(axis_names=("shard",), devices=[dev] * ns)
        t = time.perf_counter()
        searchers = [ShardedFlatSearcher(c, w, mesh, axis="shard", store_dtype=dt)
                     for dt in ("fp32", "int8")]
        torch.cuda.synchronize()
        print(f"sharded {name}: {ns} shards of {searchers[0].shard_rows} rows placed in "
              f"{time.perf_counter() - t:.2f} s", flush=True)
        for (b, k), answers in want.items():
            for searcher in searchers:
                dt = searcher.store_dtype
                for method in SHARD_METHODS[dt]:
                    rows.append(shard_row(name, searcher, method, queries[b], k, answers[dt],
                                          unsharded["int8" if dt == "int8" else method],
                                          n, reps))
        del searchers
    del cp, wp, mp, c8, cs, cstore, want
    torch.cuda.empty_cache()
    return rows


def sharded_store_checks(served, queries):
    """The sharded store over 4 logical shards of cuda:0 against the
    unsharded served store (STORE_SHARDED=on on one card, F3): the same
    hits for every fp32 method; int8 shards with exact scores and recall
    against exact. The B = 8 searches of "exact" (K2 per shard), "fast"
    (K1) and "chunkstream" (K1 + K5) are the main path of the sharded
    store: their launches are counted with the counts set to 0 just
    before."""
    import dataclasses

    import torch

    from rag_icd10_tpu_torch.index.vector_store import VectorStore
    from rag_icd10_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axis_names=("shard",), devices=[torch.device(DEVICE, 0)] * 4)
    stores = {}
    for dtype in ("float32", "int8"):
        store = VectorStore(dim=DIM, config=dataclasses.replace(
            served.config, device_dtype=dtype, sharded="on"), device=DEVICE, mesh=mesh)
        store.corpus, store._vectors = served.corpus, served._vectors
        store.load_collection()
        check(store.get_memory_usage()["sharded"] and store._dev is None,
              f"{dtype} store sharded over 4 logical shards")
        stores[dtype] = store
    q8 = queries[8]
    zero_launch_counts()
    main_hits = {m: stores["float32"].search(q8, TIER_K, method=m)
                 for m in ("exact", "fast", "chunkstream")}
    torch.cuda.synchronize()
    launches = launch_counts()
    for name, n in (("K1", 8), ("K2", 4), ("K5", 4)):
        check(launches[name] >= n, f"sharded store main path: {name} launched "
              f"{launches[name]} times")
    out = {"launches": launches, "rows": []}
    for b, q in queries.items():
        q_np = q.cpu().numpy()
        exact = served.search(q, TIER_K, method="exact")
        for method in ("exact", "streaming", "fast", "chunkstream", "approx"):
            hits = (main_hits[method] if b == 8 and method in main_hits
                    else stores["float32"].search(q, TIER_K, method=method))
            want = served.search(q, TIER_K, method=method)
            for g, e in zip(hits, want):
                same_candidates([h.to_dict() for h in g], [h.to_dict() for h in e],
                                f"sharded store {method} B={b} vs unsharded")
            out["rows"].append({
                "store": "float32", "method": method, "B": b, "k": TIER_K,
                "ms": wall_ms(lambda: stores["float32"].search(q, TIER_K, method=method)),
                "unsharded_ms": wall_ms(lambda: served.search(q, TIER_K, method=method))})
        hits = stores["int8"].search(q, TIER_K)
        err = exact_score_err(served, q_np, hits)
        recall = recall_at_k(hits, exact)
        check(err <= 1e-5, f"sharded int8 B={b}: served scores {err} from exact")
        check(recall >= 0.9, f"sharded int8 B={b}: recall@{TIER_K} {recall}")
        out["rows"].append({"store": "int8", "method": "exact", "B": b, "k": TIER_K,
                            "recall_at_k": recall, "max_score_err_vs_exact": err,
                            "ms": wall_ms(lambda: stores["int8"].search(q, TIER_K))})
    for row in out["rows"]:
        print("sharded store " + json.dumps(row), flush=True)
    out["device_vector_bytes"] = {d: s.get_memory_usage()["device_vector_bytes"]
                                  for d, s in stores.items()}
    for store in stores.values():
        store.release_collection()
    return out


def nccl_row(c, w, q):
    """parallel.multihost.initialize with NCCL at world size 1 (tcp on a
    free port): a process-group mesh of 4 logical shards of cuda:0 must
    give the local merge's answer, and global_sum one all_reduce's."""
    import torch
    import torch.distributed as dist

    from rag_icd10_tpu_torch.parallel import ShardedFlatSearcher, make_mesh, multihost

    dev = torch.device(DEVICE, 0)
    local = ShardedFlatSearcher(c, w, make_mesh(axis_names=("shard",), devices=[dev] * 4,
                                                distributed=False), axis="shard")
    t = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, local_device_count=1,
                         device=DEVICE, timeout_s=60)
    row = {"backend": None, "world_size": 1, "shards": 4, "B": q.shape[0], "k": TIER_K,
           "init_s": time.perf_counter() - t}
    try:
        mesh = make_mesh(axis_names=("shard",), devices=[dev] * 4)
        check(mesh.group is not None, "the mesh carries the process group")
        row["backend"] = dist.get_backend(mesh.group)
        check(row["backend"] == "nccl", f"backend {row['backend']}")
        searcher = ShardedFlatSearcher(c, w, mesh, axis="shard")
        for method in ("auto", "chunkstream"):
            gv, gi = searcher.search_device(q, TIER_K, method)
            lv, li = local.search_device(q, TIER_K, method)
            same_up_to_ties(gv.cpu().numpy(), gi.cpu().numpy(), lv.cpu().numpy(),
                            li.cpu().numpy(), f"nccl {method} vs the local merge", 0.0)
            row[f"{method}_host_ms"] = wall_ms(
                lambda: searcher.search_device(q, TIER_K, method))
            row[f"{method}_local_host_ms"] = wall_ms(
                lambda: local.search_device(q, TIER_K, method))
        parts = multihost.global_device_put(torch.arange(64.0, device=dev), mesh, "shard")
        row["global_sum"] = multihost.global_sum(parts, mesh)
        check(row["global_sum"] == 2016.0, f"global_sum {row['global_sum']}")
    finally:
        multihost.shutdown()
    print("nccl " + json.dumps(row), flush=True)
    return row


def sharded_phase(cfg, queries):
    """The sharded rows over the served corpus (the built store) and
    the 1M-row corpus, the sharded store against the unsharded one, and
    the NCCL row. Returns the rows, the store checks and the NCCL row."""
    import torch

    from rag_icd10_tpu_torch.index.vector_store import VectorStore

    t0 = time.perf_counter()
    served = VectorStore.load(cfg.store.db_path, config=cfg.store, device=DEVICE)
    served.load_collection()
    check(not served.get_memory_usage()["sharded"], "F3: the served store is unsharded")
    dev = torch.device(DEVICE, 0)
    c = torch.from_numpy(served._vectors).to(dev)
    w = torch.from_numpy(served.corpus.level_weights(cfg.store.level_weights)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    rows = sharded_rows("served", c, w, gen, reps=10)
    store = sharded_store_checks(served, queries)
    nccl = nccl_row(c, w, queries[8])
    served.release_collection()
    del c, w, served
    torch.cuda.empty_cache()
    big_c, big_w, _ = large_corpus()
    rows += sharded_rows("1M", big_c, big_w, gen, reps=3)
    del big_c, big_w
    torch.cuda.empty_cache()
    print(f"sharded phase took {time.perf_counter() - t0:.1f} s", flush=True)
    return rows, store, nccl


# ---------------------------------------------------------------------------
# Fused + NER phase (FUSED_QUERY=1, NER_WEIGHTS_PATH): the encoder, K1/K2
# and torch.topk as one CUDA graph replay per bucket; NER in model mode.
# ---------------------------------------------------------------------------

NER_LABELS = (  # rag_icd10_tpu/tools/train_ner.py:39-45
    "O", "B-Disease", "I-Disease", "B-Symptom", "I-Symptom",
    "B-BodyParts", "I-BodyParts", "B-Drug", "I-Drug",
)
TOL_NER_FP32 = 1e-5  # fp32 forwards on the card and the CPU, sums in other orders
TOL_NER_BF16 = 2e-2  # bf16 dense layers round at other places on the two devices
TOL_EMB = 1e-5  # a graph replay against the same kernels run eagerly
FUSED_BATCHES = (1, 8, 64)
FUSED_KS = (20, 100)


def write_ner_weights(vocab_path, out_dir: Path, seed: int = 1):
    """A BERT-base token classifier (12 layers, 768 hidden, 12 heads, 3072
    intermediate, vocab 21,128) with seeded weights and a seeded 9-label
    head, written as params.npz, config.json and vocab.txt with the port's
    converter functions."""
    import shutil

    import numpy as np

    from rag_icd10_tpu_torch.models.bert import BertArch, init_params
    from rag_icd10_tpu_torch.models.convert_hf import save_params

    a = BertArch()
    params = init_params(a, seed=seed)
    rng = np.random.default_rng(seed + 1)
    # logits of std about 3 over the 9 labels: peaked enough that spans
    # pass the 0.5 confidence floor
    params["classifier"] = {
        "kernel": rng.standard_normal((a.hidden_size, len(NER_LABELS)), dtype=np.float32)
        * np.float32(3.0 / np.sqrt(a.hidden_size)),
        "bias": np.zeros(len(NER_LABELS), np.float32),
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    save_params(params, str(out_dir / "params.npz"))
    shutil.copy(vocab_path, out_dir / "vocab.txt")
    (out_dir / "config.json").write_text(json.dumps({
        "vocab_size": a.vocab_size, "hidden_size": a.hidden_size,
        "num_hidden_layers": a.num_layers, "num_attention_heads": a.num_heads,
        "intermediate_size": a.intermediate_size,
        "max_position_embeddings": a.max_position_embeddings,
        "id2label": {str(i): label for i, label in enumerate(NER_LABELS)},
    }))
    return a


def ner_card_vs_cpu(ner_dir: Path, reps: int = 5) -> dict:
    """The NER classifier on the card against the same model on the CPU on
    the 8 QUERIES: probabilities within TOL_NER_BF16 at bf16 (the served
    dtype) and within TOL_NER_FP32 at fp32, where the spans must be the
    same too; and the card's time per forward (host clock: predict ends
    in its read back)."""
    import numpy as np
    import torch

    from rag_icd10_tpu_torch.pipeline.ner_model import TorchTokenClassifier

    out = {}
    for name, dtype, tol in (("bf16", torch.bfloat16, TOL_NER_BF16),
                             ("fp32", torch.float32, TOL_NER_FP32)):
        card = TorchTokenClassifier.from_weights(str(ner_dir), device=DEVICE, compute_dtype=dtype)
        host = TorchTokenClassifier.from_weights(str(ner_dir), device="cpu", compute_dtype=dtype)
        check((card.arch.num_layers, card.arch.hidden_size, card.arch.num_heads,
               card.arch.intermediate_size) == (12, 768, 12, 3072),
              f"full-width BERT-base NER classifier, got {card.arch}")
        err, spans = 0.0, 0
        for text, _ in QUERIES:
            _, _, ids, mask = host.encode(text)
            err = max(err, float(np.abs(card.probabilities(ids, mask)
                                        - host.probabilities(ids, mask)).max()))
            if dtype == torch.float32:
                got, want = card.predict(text), host.predict(text)
                check([s[:2] + s[3:] for s in got] == [s[:2] + s[3:] for s in want],
                      f"NER fp32 spans on the card vs the CPU: {text!r}")
                check(all(abs(g[2] - w[2]) <= tol for g, w in zip(got, want)),
                      f"NER fp32 span scores on the card vs the CPU: {text!r}")
                spans += len(got)
        check(err <= tol, f"NER {name} probabilities card vs CPU {err} > {tol}")
        for text, _ in QUERIES:
            card.predict(text)
        before, t = card.forwards, time.perf_counter()
        for _ in range(reps):
            for text, _ in QUERIES:
                card.predict(text)
        out[name] = {"max_abs_err": err, "tol": tol,
                     "ms_per_forward": (time.perf_counter() - t) * 1e3 / (card.forwards - before)}
        if dtype == torch.float32:
            out[name]["spans"] = spans
        del card, host
    torch.cuda.empty_cache()
    return out


def same_up_to_ties(got_v, got_i, want_v, want_i, what, tol: float = TOL_FP32):
    """Values within ``tol``; an id in one top-k and not the other scores
    within ``tol`` of the k-th value (a tie at the boundary)."""
    import numpy as np

    err = float(np.abs(np.asarray(got_v) - np.asarray(want_v)).max())
    check(err <= tol, f"{what}: values differ by {err}")
    for gv, gi, wv, wi in zip(got_v, got_i, want_v, want_i):
        g, w = dict(zip(gi.tolist(), gv.tolist())), dict(zip(wi.tolist(), wv.tolist()))
        for j in g.keys() ^ w.keys():
            check(abs(g.get(j, w.get(j)) - float(wv[-1])) <= tol, f"{what}: id {j}")
    return err


def fused_engine_rows(engine, corpus) -> list:
    """FusedQueryEngine.query at B in FUSED_BATCHES and k in FUSED_KS:
    exact, approx and streaming over the served fp32 store, exact over a
    bf16 store of the same rows. Each replay is held against the eager
    two-step path (the encoder, the kernel's plain version, torch.topk);
    each key's second query is a pure replay whose launches are counted;
    the replay and the same chain run eagerly are timed on the card and
    on the host."""
    import dataclasses

    import numpy as np
    import torch

    from rag_icd10_tpu_torch.index.vector_store import VectorStore
    from rag_icd10_tpu_torch.ops.flat_topk import weighted_scores_reference
    from rag_icd10_tpu_torch.ops.fused_query import FusedQueryEngine, replay_launches

    bf16 = VectorStore(dim=engine.store.dim, config=dataclasses.replace(
        engine.store.config, device_dtype="bfloat16"), device=DEVICE)
    bf16.corpus, bf16._vectors = engine.store.corpus, engine.store._vectors
    bf16.load_collection()
    n = engine.store.num_entities
    texts_by_b = {1: [QUERIES[0][0]], 8: [t for t, _ in QUERIES],
                  64: corpus.titles[:: max(1, n // 64)][:64]}
    rows = []
    for store, method in ((engine.store, "exact"), (engine.store, "approx"),
                          (engine.store, "streaming"), (bf16, "exact")):
        fq = FusedQueryEngine(engine.encoder, store)
        dev = store._dev
        corpus_t, w, m = dev["corpus"], dev["weights"], dev["mask"]
        residency = str(corpus_t.dtype).replace("torch.", "")
        for b, texts in texts_by_b.items():
            for k in FUSED_KS:
                what = f"fused {residency} {method} B={b} k={k}"
                fq.query(texts, k=k, method=method)  # warm-up, capture, replay
                zero_launch_counts()
                emb, vals, idx = fq.query(texts, k=k, method=method)
                counts = launch_counts()
                k1, k2, _ = replay_launches(k, method)
                check((counts["K1"], counts["K2"]) == (k1, k2),
                      f"{what}: one replay launched {counts}")
                with torch.inference_mode():
                    q = engine.encoder.encode_queries_device(texts)
                    plain = weighted_scores_reference(q.to(corpus_t.dtype), corpus_t, w, m)
                    pv, pi = torch.topk(plain, k, dim=1)
                emb_err = float(np.abs(emb - q.cpu().numpy()).max())
                check(emb_err <= TOL_EMB, f"{what}: embeddings differ by {emb_err}")
                err = same_up_to_ties(vals, idx, pv.cpu().numpy(), pi.cpu().numpy(), what)
                inp = torch.from_numpy(fq.tokenize(texts)).to(DEVICE)

                def eager():
                    with torch.inference_mode():
                        fq._compute(inp, k, method, dev)

                graph = fq._graphs[(*inp.shape[1:], k, method, corpus_t.dtype)].graph
                t = time.perf_counter()
                for _ in range(10):
                    fq.query(texts, k=k, method=method)
                rows.append({
                    "residency": residency, "method": method, "B": b, "k": k,
                    "rows": inp.shape[1], "seq": inp.shape[2],
                    "launches_per_replay": {"K1": counts["K1"], "K2": counts["K2"]},
                    "emb_max_abs_err": emb_err, "max_abs_err": err,
                    "query_ms": (time.perf_counter() - t) * 1e2,
                    "replay_ms": time_ms(graph.replay),
                    "replay_device_ms": device_ms(graph.replay),
                    "replay_host_ms": host_ms(graph.replay),
                    "eager_ms": time_ms(eager), "eager_device_ms": device_ms(eager),
                    "eager_host_ms": host_ms(eager),
                })
                print("fused engine " + json.dumps(rows[-1]), flush=True)
        stats = fq.stats()
        if method == "streaming":
            check(stats["certified"] == stats["streaming_queries"] and stats["redos"] == 0,
                  f"fused streaming certified {stats['certified']}/"
                  f"{stats['streaming_queries']}, {stats['redos']} redone")
        rows[-1]["engine_stats"] = stats
    return rows


async def serve_fused(cfg, engine_probe):
    """Start the port's API server with FUSED_QUERY=1 and NER model mode
    (the environment set by the caller), send QUERIES twice timed and
    once under torch.profiler with the default method, then once with
    search_method "exact" (the two-step path, same server, same NER).
    Returns the run's counts, latencies, responses and profile."""
    import aiohttp
    import torch
    from aiohttp import web

    from rag_icd10_tpu_torch.api.app import APIServer
    from rag_icd10_tpu_torch.utils.metrics import metrics

    server = APIServer(config=cfg, device=DEVICE)
    runner = web.AppRunner(server.app)
    t0 = time.perf_counter()
    await runner.setup()  # Engine.startup: the warmup captures the graphs
    site = web.TCPSite(runner, cfg.api.host, cfg.api.port)
    await site.start()
    run = {"startup_s": time.perf_counter() - t0}
    engine = server.engine
    fused = engine.matcher._fused
    check(fused is not None, "FUSED_QUERY=1: the warmup built the fused engine")
    check(engine.ner.use_model and engine.ner._model is not None,
          f"NER model mode loaded ({engine.ner.fallback_reason})")
    run["warmup_fused"] = fused.stats()
    print(f"fused server up in {run['startup_s']:.1f} s; warmup captured "
          f"{run['warmup_fused']['graphs']} graphs in "
          f"{run['warmup_fused']['capture_s']:.2f} s", flush=True)
    url = f"http://{cfg.api.host}:{cfg.api.port}"

    async def query_pass(session, lat, out, method=None):
        for text, top_k in QUERIES:
            payload = {"text": text, "top_k": top_k}
            if method:
                payload["search_method"] = method
            t = time.perf_counter()
            async with session.post(url + "/query", json=payload) as resp:
                body = await resp.json()
                status = resp.status
            if lat is not None:
                lat.append((time.perf_counter() - t) * 1e3)
            out.append((text, top_k, status, body))

    run["latencies"], run["responses"] = [], []
    run["exact_latencies"], run["exact_responses"] = [], []
    try:
        async with aiohttp.ClientSession() as session:
            fused0, batch0 = fused.stats(), server.batcher.stats()
            ner0 = engine.ner.stats()
            zero_launch_counts()  # the fused path's requests only
            metrics.reset()
            for _ in range(2):
                await query_pass(session, run["latencies"], run["responses"])
            run["launches"] = launch_counts()
            run["stages"] = metrics.snapshot()
            fused1, batch1 = fused.stats(), server.batcher.stats()
            ner1 = engine.ner.stats()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t = time.perf_counter()
                await query_pass(session, None, [])
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
            metrics.reset()
            await query_pass(session, run["exact_latencies"], run["exact_responses"], "exact")
            run["exact_stages"] = metrics.snapshot()
            async with session.get(url + "/stats") as resp:
                run["stats"] = await resp.json()
        engine_probe(engine)
    finally:
        await runner.cleanup()
    run["replays"] = fused1["replays"] - fused0["replays"]
    run["eager"] = fused1["eager"] - fused0["eager"]
    run["graphs_after"] = fused1["graphs"]
    run["batches"] = batch1["batches_served"] - batch0["batches_served"]
    run["ner"] = {key: ner1[key] - ner0[key]
                  for key in ("model_extractions", "rule_fallbacks", "model_forwards")}
    run["ner_total"] = {key: ner1[key] for key in ("model_extractions", "rule_fallbacks")}
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(ms for _, ms, _ in kernels)
    run["device"] = {
        "requests": len(QUERIES), "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "k1_ms": sum(ms for key, ms, _ in kernels if "fused_score" in key),
        "top": [{"kernel": key[:80], "ms": ms, "count": n} for key, ms, n in kernels[:8]],
    }
    return run


def fused_phase(corpus, cfg, two_step):
    """The fused + NER phase over the saved store: NER weights written and
    held card against CPU, the FUSED_QUERY=1 server with NER model mode,
    and the engine-level rows. ``two_step`` holds the earlier phase's
    exact server: its p50 and stages."""
    import dataclasses
    import os
    import tempfile

    import numpy as np

    from rag_icd10_tpu_torch import config as tconfig

    found = {}
    with tempfile.TemporaryDirectory() as tmp:
        ner_dir = Path(tmp) / "ner"
        t = time.perf_counter()
        write_ner_weights(cfg.store.db_path + ".vocab.txt", ner_dir)
        found["ner_write_s"] = time.perf_counter() - t
        found["ner_card_vs_cpu"] = ner_card_vs_cpu(ner_dir)
        print("NER card vs CPU " + json.dumps(found["ner_card_vs_cpu"]), flush=True)
        env = {"FUSED_QUERY": "1", "NER_WEIGHTS_PATH": str(ner_dir)}
        saved = {key: os.environ.get(key) for key in env}
        os.environ.update(env)
        fcfg = dataclasses.replace(
            cfg, api=dataclasses.replace(cfg.api, port=free_port()),
            ner=tconfig.NERConfig(use_model=True),
        )

        def probe(engine):
            found["engine_rows"] = fused_engine_rows(engine, corpus)

        try:
            run = asyncio.run(serve_fused(fcfg, probe))
        finally:
            for key, value in saved.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value

    n_req = len(run["responses"])
    for (text, top_k, status, body), (_, _, estatus, ebody) in zip(
            run["responses"], run["exact_responses"] * 2):
        check(status == 200 and estatus == 200, f"fused /query {text!r}: {status} {body}")
        cands = body["candidates"]
        check(1 <= len(cands) <= top_k and all(np.isfinite(c["score"]) for c in cands),
              f"fused /query {text!r}: {len(cands)} candidates")
        same_candidates(cands, ebody["candidates"], f"fused /query {text!r} vs two-step exact")
    stages = run["stages"]
    check("encode+search(fused)" in stages and "encode" not in stages and "search" not in stages,
          f"every fused request took the fused path: stages {sorted(stages)}")
    check(stages["encode+search(fused)"]["count"] == run["batches"] == run["replays"]
          and run["eager"] == 0,
          f"one replay per coalesced batch: {stages['encode+search(fused)']['count']} fused "
          f"stages, {run['batches']} batches, {run['replays']} replays, {run['eager']} eager")
    check(run["launches"]["K1"] == run["replays"] and run["launches"]["K2"] == 0,
          f"K1 once per replay: {run['launches']} in {run['replays']} replays")
    check(run["device"]["k1_ms"] > 0, "the profiled fused requests ran K1 on the card")
    check(run["ner"]["model_extractions"] > 0, "NER model-mode extractions ran")
    check(run["ner_total"]["rule_fallbacks"] == 0,
          f"NER fell back to rules {run['ner_total']['rule_fallbacks']} times")
    check("fused_query" in run["stats"] and run["stats"]["ner"]["use_model"],
          "/stats reports the fused engine and NER model mode")
    p50 = statistics.median(run["latencies"])
    exact_p50 = statistics.median(run["exact_latencies"])
    fused_stage = stages["encode+search(fused)"]["p50_ms"]
    ts = two_step["stages"]
    two_step_ms = sum(ts[key]["p50_ms"] for key in ("encode", "search", "finalize") if key in ts)
    summary = {
        "query_p50_ms": p50, "query_max_ms": max(run["latencies"]),
        "two_step_exact_p50_ms_same_server": exact_p50,
        "two_step_exact_p50_ms_rule_ner_server": two_step["query_p50_ms"],
        "fused_stage_p50_ms": fused_stage,
        "two_step_encode_search_finalize_p50_ms": two_step_ms,
        "two_step_stages": {key: ts[key]["p50_ms"] for key in ("encode", "search", "finalize")
                            if key in ts},
        "same_server_two_step_stages": {key: v["p50_ms"]
                                        for key, v in run["exact_stages"].items()},
        "idle_share": run["device"]["idle_share"], "device": run["device"],
        "graphs": run["graphs_after"], "warmup_graphs": run["warmup_fused"]["graphs"],
        "capture_s": run["warmup_fused"]["capture_s"], "replays": run["replays"],
        "batches": run["batches"], "requests": n_req, "startup_s": run["startup_s"],
        "k1_launches": run["launches"]["K1"],
        "ner_extractions": run["ner"]["model_extractions"],
        "ner_rule_fallbacks": run["ner_total"]["rule_fallbacks"],
        "ner_forwards_per_request": run["ner"]["model_forwards"] / n_req,
        "ner_ms_per_forward_bf16": found["ner_card_vs_cpu"]["bf16"]["ms_per_forward"],
        "ner_card_vs_cpu": found["ner_card_vs_cpu"], "ner_write_s": found["ner_write_s"],
        "stages": {key: v["p50_ms"] for key, v in stages.items()},
    }
    print(f"/query fused + NER: {n_req} requests, p50 {p50:.2f} ms, max "
          f"{max(run['latencies']):.2f} ms; two-step exact on the same server p50 "
          f"{exact_p50:.2f} ms; two-step exact (rule NER) p50 "
          f"{two_step['query_p50_ms']:.2f} ms", flush=True)
    print(f"encode+search(fused) p50 {fused_stage:.3f} ms against encode + search + finalize "
          f"{two_step_ms:.3f} ms ({json.dumps(summary['two_step_stages'])}); idle share "
          f"{run['device']['idle_share']:.4f}; {run['graphs_after']} graphs, captured in "
          f"{run['warmup_fused']['capture_s']:.2f} s; {run['replays']} replays, K1 "
          f"{run['launches']['K1']}; NER {summary['ner_forwards_per_request']:.2f} forwards "
          f"per request, {summary['ner_ms_per_forward_bf16']:.3f} ms per forward", flush=True)
    print("fused " + json.dumps(summary), flush=True)
    return summary, found["engine_rows"]


# ---------------------------------------------------------------------------
# Train phase (tools/train_encoder.py, parallel/train.py, the eval gate):
# full-width BERT-base (bf16 compute, fp32 parameters) on triplet batches
# of the synthetic corpus at the CLI's defaults; then the CLI end to end
# with its eval gate, whose searches launch K1.

TRAIN_BATCH, TRAIN_SEQ_A, TRAIN_SEQ_B = 256, 48, 96  # the CLI's defaults
TRAIN_WARM, TRAIN_TIMED, TRAIN_PROFILED = 3, 20, 3
TRAIN_PAIR_STEPS, TRAIN_PAIR_BATCH = 3, 8  # card against CPU
GATE_STEPS = 20
TOL_TRAIN_BF16 = 2e-2  # bf16 dense layers round at other places on the two devices
TOL_TRAIN_FP32 = 1e-4  # fp32 sums in other orders; Adam turns near-zero gradients' rounding
#                        into update differences of up to the learning rate


def train_batches(corpus, tok, n: int, rows: int, seed: int):
    """``n`` triplet batches of ``rows`` as the CLI draws them: hard
    negatives, augmentation 0.4, markers 0.25, cousins 0.3, the weighted
    loss's level weights, over successive rows of one permutation."""
    import numpy as np

    from rag_icd10_tpu_torch.tools.train_encoder import (
        build_examples,
        draw_batch,
        title_weight_map,
    )

    weights = (1.2, 1.0, 0.8)
    examples, title_ids = build_examples(corpus, level_weights=weights)
    title_weights = title_weight_map(corpus, weights)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(examples))
    return [draw_batch(examples, order[i * rows:(i + 1) * rows], corpus.titles, title_ids,
                       rng, tok, TRAIN_SEQ_A, TRAIN_SEQ_B, 0.4, 0.25, 0.3, 0.0, title_weights)
            for i in range(n)]


def step_tflop(batch) -> float:
    """Dense matmul TFLOP of one training step (forward and backward, 3x
    the forward's 2 flops a multiply-add) from the batch's shapes:
    BERT-base's projections and FFN on every token, and the attention
    products on every (query, key) pair."""
    h, inter, layers = 768, 3072, 12
    flops = 0.0
    for side in ("a", "h", "b"):
        rows, seq = batch[f"{side}_ids"].shape
        per_token = 2 * (4 * h * h + 2 * h * inter) + 2 * 2 * seq * h
        flops += 3 * layers * rows * seq * per_token
    return flops / 1e12


def train_card_vs_cpu(arch, params, batches) -> dict:
    """The same seeded steps at batch 8 on the card and on the CPU, bf16
    compute (the trained configuration) and fp32 compute, under the CLI's
    schedule for --steps 20 (the first step at lr 0). Returns each step's
    loss on both."""
    import dataclasses

    import numpy as np
    import torch

    from rag_icd10_tpu_torch.parallel.train import (
        init_train_state,
        make_train_step,
        warmup_cosine_decay_schedule,
    )

    schedule = warmup_cosine_decay_schedule(0.0, 1e-4, min(100, GATE_STEPS // 10 + 1),
                                            GATE_STEPS)
    out = {}
    for name, dtype, tol in (("bf16", torch.bfloat16, TOL_TRAIN_BF16),
                             ("fp32", torch.float32, TOL_TRAIN_FP32)):
        losses = {}
        for dev in (DEVICE, "cpu"):
            state = init_train_state(dataclasses.replace(arch, compute_dtype=dtype),
                                     params=params, schedule=schedule, device=dev)
            check(all(p.dtype == torch.float32 and p.device.type == torch.device(dev).type
                      for p in state.model.parameters()),
                  f"fp32 parameters on {dev}")
            step = make_train_step()
            losses[dev] = [float(step(state, b)["loss"]) for b in batches]
            del state
        err = max(abs(a - b) for a, b in zip(losses[DEVICE], losses["cpu"]))
        check(all(np.isfinite(losses[DEVICE] + losses["cpu"])), f"finite {name} losses")
        check(err <= tol, f"train {name} loss card vs CPU {err} > {tol}: {losses}")
        out[name] = {"card": losses[DEVICE], "cpu": losses["cpu"], "max_abs_err": err,
                     "tol": tol}
    torch.cuda.empty_cache()
    return out


def train_timing(arch, params, batches) -> dict:
    """ms per step and samples/s at batch 256 over TRAIN_TIMED steps after
    TRAIN_WARM (CUDA events; each step reads its loss back, as the CLI's
    loop does), peak device memory, and the card's busy share: the
    kernels' time per step over TRAIN_PROFILED traced steps
    (torch.profiler) over the untraced step time, and over the traced
    steps' own wall time."""
    import numpy as np
    import torch

    from rag_icd10_tpu_torch.parallel.train import init_train_state, make_train_step

    state = init_train_state(arch, params=params, schedule=1e-4, device=DEVICE)
    step = make_train_step()
    torch.cuda.reset_peak_memory_stats()
    for b in batches[:TRAIN_WARM]:
        float(step(state, b)["loss"])
    timed = batches[TRAIN_WARM:TRAIN_WARM + TRAIN_TIMED]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    losses = [float(step(state, b)["loss"]) for b in timed]
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / len(timed)
    peak = torch.cuda.max_memory_allocated()
    # CUDA activity only: with CPU ops traced too, ops run by autograd's
    # backward thread carry their kernels' device time as well, and a sum
    # over every event counts those kernels twice
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for b in batches[:TRAIN_PROFILED]:
            float(step(state, b)["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
                      if e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_ms = sum(ms_ for _, ms_ in kernels)
    check(all(np.isfinite(losses)), f"finite losses at batch {TRAIN_BATCH}: {losses}")
    check(0 < busy_ms <= wall_ms, f"the profiled steps' kernels: {busy_ms} ms in {wall_ms} ms")
    tflop = step_tflop(timed[0])
    row = {"batch": TRAIN_BATCH, "seq_a": TRAIN_SEQ_A, "seq_b": TRAIN_SEQ_B,
           "warm_steps": TRAIN_WARM, "timed_steps": len(timed), "ms_per_step": ms,
           "samples_per_s": TRAIN_BATCH / (ms / 1e3), "peak_mem_gib": peak / 2**30,
           "step_tflop": tflop, "tflop_per_s": tflop / (ms / 1e3),
           "bf16_peak_share": tflop / (ms / 1e3) / (PEAK_FLOPS["bf16"] / 1e12),
           "busy_ms_per_step": busy_ms / TRAIN_PROFILED,
           "busy_share": busy_ms / TRAIN_PROFILED / ms,  # kernel time over the untraced step
           "busy_share_traced": busy_ms / wall_ms,
           "profiled_wall_ms_per_step": wall_ms / TRAIN_PROFILED,
           "top": [{"kernel": key[:80], "ms_per_step": v / TRAIN_PROFILED}
                   for key, v in kernels[:6]],
           "losses": losses}
    del state
    torch.cuda.empty_cache()
    return row


def gate_run(corpus) -> dict:
    """``tools/train_encoder.main`` end to end on the card: the corpus as a
    CSV under a temporary directory (ICD_DATA_PATH), GATE_STEPS steps at
    the CLI's defaults with --weighted-loss, then --eval-gate 0.0. The
    embed and the eval are timed by wrapping the functions the gate calls;
    every step's loss is recorded the same way; K1's launches are counted
    over the whole run (training launches none)."""
    import csv
    import os
    import tempfile

    import numpy as np

    from rag_icd10_tpu_torch.eval import retrieval
    from rag_icd10_tpu_torch.parallel import train as ptrain
    from rag_icd10_tpu_torch.tools import build_database, train_encoder

    seconds = {"embed_s": 0.0, "eval_s": 0.0}
    losses = []

    def timed(fn, key):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[key] += time.perf_counter() - t
        return run

    def recording(make):
        def make_step(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(state, batch):
                m = step(state, batch)
                losses.append(float(m["loss"]))
                return m
            return run
        return make_step

    patches = [(build_database, "embed_sorted", timed(build_database.embed_sorted, "embed_s")),
               (retrieval, "evaluate", timed(retrieval.evaluate, "eval_s")),
               (ptrain, "make_train_step", recording(ptrain.make_train_step))]
    saved_attrs = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = Path(tmp) / "icd10.csv"
        with open(csv_path, "w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f)
            writer.writerow(["code", "disease"])
            writer.writerows(zip(corpus.codes, corpus.titles))
        env = {"ICD_DATA_PATH": str(csv_path), "EMBEDDING_VOCAB_PATH": "",
               "EMBEDDING_WEIGHTS_PATH": ""}
        saved_env = {key: os.environ.get(key) for key in env}
        os.environ.update(env)
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        out = Path(tmp) / "trained"
        zero_launch_counts()
        try:
            t = time.perf_counter()
            rc = train_encoder.main(
                ["--steps", str(GATE_STEPS), "--batch", str(TRAIN_BATCH), "--weighted-loss",
                 "--eval-gate", "0.0", "--out", str(out), "--log-every", "5",
                 "--save-every", "0"], device=DEVICE)
            total_s = time.perf_counter() - t
        finally:
            for mod, name, fn in saved_attrs:
                setattr(mod, name, fn)
            for key, value in saved_env.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
        counts = launch_counts()
        gate = json.loads((out / "eval_gate.json").read_text(encoding="utf-8"))
        files = sorted(p.name for p in out.iterdir())
    check(rc == 0 and gate["blessed"] is True, f"the gate blessed the weights: rc {rc}, {gate}")
    check(len(losses) == GATE_STEPS and all(np.isfinite(losses)),
          f"{len(losses)} finite losses of {GATE_STEPS}: {losses}")
    check(counts["K1"] > 0, f"the gate's searches launched K1: {counts}")
    check({"params.npz", "vocab.txt", "opt_state.npz", "eval_gate.json"} <= set(files),
          f"the CLI wrote its checkpoint: {files}")
    return {"steps": GATE_STEPS, "total_s": total_s, **seconds,
            "train_and_other_s": total_s - seconds["embed_s"] - seconds["eval_s"],
            "losses": losses, "k1_launches": counts["K1"], "launches": counts,
            "blessed": gate["blessed"], "candidate": gate["candidate"],
            "gate_metric": gate["gate_metric"], "tiers": gate["tiers"]}


def train_phase(corpus) -> dict:
    """Card against CPU at batch 8, the timing at batch 256, then the CLI
    with its eval gate."""
    import torch

    from rag_icd10_tpu_torch.data.augment import augmentation_charset_texts
    from rag_icd10_tpu_torch.models.bert import BertArch, init_params
    from rag_icd10_tpu_torch.models.tokenizer import WordPieceTokenizer

    t0 = time.perf_counter()
    tok = WordPieceTokenizer.from_corpus(corpus.titles + corpus.semantic_texts
                                         + augmentation_charset_texts())
    arch = BertArch(vocab_size=max(21128, tok.vocab_size))
    check((arch.num_layers, arch.hidden_size, arch.num_heads, arch.intermediate_size,
           arch.compute_dtype) == (12, 768, 12, 3072, torch.bfloat16),
          f"full-width BERT-base, got {arch}")
    params = init_params(arch, seed=0)
    t = time.perf_counter()
    batches = train_batches(corpus, tok, TRAIN_WARM + TRAIN_TIMED, TRAIN_BATCH, seed=0)
    draw_ms = (time.perf_counter() - t) * 1e3 / len(batches)
    found = {"card_vs_cpu": train_card_vs_cpu(
        arch, params, train_batches(corpus, tok, TRAIN_PAIR_STEPS, TRAIN_PAIR_BATCH, seed=1))}
    print("train card vs CPU " + json.dumps(found["card_vs_cpu"]), flush=True)
    found["step"] = {**train_timing(arch, params, batches), "host_draw_ms_per_batch": draw_ms}
    step = found["step"]
    print(f"train step: batch {TRAIN_BATCH}, {step['ms_per_step']:.2f} ms per step, "
          f"{step['samples_per_s']:.1f} samples/s, peak {step['peak_mem_gib']:.2f} GiB, "
          f"{step['tflop_per_s']:.1f} TFLOP/s dense ({step['bf16_peak_share']:.3f} of the bf16 "
          f"peak), busy share {step['busy_share']:.3f}; host draw "
          f"{draw_ms:.1f} ms a batch", flush=True)
    del params, batches
    found["gate"] = gate_run(corpus)
    gate = found["gate"]
    print(f"eval gate: {gate['steps']} steps + gate in {gate['total_s']:.1f} s (embed "
          f"{gate['embed_s']:.1f} s, eval {gate['eval_s']:.1f} s), K1 {gate['k1_launches']} "
          f"launches, blessed {gate['blessed']}, tiers {json.dumps(gate['tiers'])}", flush=True)
    found["phase_s"] = time.perf_counter() - t0
    print("train " + json.dumps(found), flush=True)
    return found


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import rag_icd10_tpu_torch

    pkg = Path(rag_icd10_tpu_torch.__file__).resolve()
    if ROOT not in pkg.parents:
        print(f"chip_smoke: rag_icd10_tpu_torch imported from {pkg}, not this "
              "checkout", file=sys.stderr)
        return 2
    jax_before = sys.modules.get("jax") is not None

    card = card_line()
    print(card, flush=True)
    from rag_icd10_tpu_torch.data.corpus import synthetic_corpus
    from rag_icd10_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in libs:
        for line in cuda_build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    corpus = synthetic_corpus(N_REAL, seed=0)
    sweep, k1_threshold, sweeps, sketch_large = kernel_phase(
        corpus.level_weights((1.2, 1.0, 0.8)))
    sweeps["K1"] = sweep
    print("K34 threshold rows " + json.dumps(sweeps.pop("threshold")), flush=True)
    main_path, e2e, cfg, stages, queries = slice_phase(corpus)
    shard_rows, shard_store, nccl = sharded_phase(cfg, queries)
    e2e["sharded_store"] = shard_store
    e2e["nccl"] = nccl
    sharded = shard_store["launches"]
    main_path["K1"]["launches_by_path"]["sharded"] = sharded["K1"]
    main_path["K2"]["launches_by_path"]["sharded"] = sharded["K2"]
    main_path["K5"]["launches_by_path"] = {"chunkstream": main_path["K5"]["launches"],
                                           "sharded": sharded["K5"]}
    for kid in ("K1", "K2", "K5"):
        main_path[kid]["sharded"] = [
            {key: r[key] for key in ("corpus", "store", "method", "shards", "B", "k",
                                     "launches", "redone", "device_ms", "host_ms")}
            for r in shard_rows if r["store"] == "fp32" and r["corpus"] == "served"
            and (r["B"], r["k"]) == (8, TIER_K)
            and SHARD_LAUNCHES[r["method"]][("K1", "K2", "K5").index(kid)]]
    fused, fused_rows = fused_phase(corpus, cfg, {"query_p50_ms": e2e["query_p50_ms"],
                                                  "stages": stages})
    e2e["fused"] = fused
    main_path["K1"]["launches_by_path"]["fused"] = fused["k1_launches"]
    main_path["K1"]["fused"] = [r for r in fused_rows if r["method"] != "streaming"]
    main_path["K2"]["launches_by_path"]["fused_streaming"] = sum(
        r["launches_per_replay"]["K2"] for r in fused_rows)
    main_path["K2"]["fused"] = [r for r in fused_rows if r["method"] == "streaming"]
    train = train_phase(corpus)
    e2e["train"] = {key: train[key] for key in ("card_vs_cpu", "step", "phase_s")}
    e2e["eval_gate"] = {key: v for key, v in train["gate"].items() if key != "launches"}
    main_path["K1"]["launches_by_path"]["eval_gate"] = train["gate"]["k1_launches"]
    check(jax_before or sys.modules.get("jax") is None, "the port imported JAX")
    check(not any(m == "rag_icd10_tpu" or m.startswith("rag_icd10_tpu.")
                  for m in sys.modules), "the port imported the JAX package")

    table = [  # (id, name, source, replaces)
        ("K1", "fused_score", "fused_score.cu", "rag_icd10_tpu/ops/pallas_score.py:31"),
        ("K2", "slot_stream", "slot_stream.cu", "rag_icd10_tpu/ops/pallas_score.py:220"),
        ("K3", "chunk_max (fp32, bf16)", "chunk_max.cu", "rag_icd10_tpu/ops/chunk_stream.py:70"),
        ("K4", "chunk_max (int8)", "chunk_max.cu", "rag_icd10_tpu/ops/chunk_stream.py:91"),
        ("K5", "gather_rescore", "gather_rescore.cu", "rag_icd10_tpu/ops/chunk_stream.py:199"),
    ]
    kernels = []
    for kid, name, src, replaces in table:
        row = main_path[kid]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"rag_icd10_tpu_torch/ops/csrc/{src}",
            "replaces": replaces,
            "launches": row["launches"],
            **{key: row[key] for key in
               ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **{key: row[key] for key in ("device_ms", "host_ms", "library_device_ms",
                                         "library_dense_ms", "library_dense_device_ms")
               if key in row},
            "shape": {key: row[key] for key in
                      ("B", "N", "D", "k", "mc", "path", "group_rows", "tile_rows")
                      if key in row},
            **({"main_batches": row["batches"]} if "batches" in row else {}),
            **({"threshold": k1_threshold} if kid == "K1" else {}),
            **{key: row[key] for key in ("launches_by_path", "chunk_select", "bf16_rerank",
                                         "fused", "sharded") if key in row},
            "sweep": sweeps[kid],
        })
    e2e["sketch_1M"] = sketch_large
    print("e2e " + json.dumps(e2e), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
