"""Training cell: ``tools/train_encoder.py``'s own ``main`` and loop.

The benchmark writes the job's inputs from the seed (the corpus as a CSV
for ``ICD_DATA_PATH``, ``vocab.txt``, and the starting weights as the
configuration's family hands them over beside it), replaces
``parallel.train.make_train_step`` and ``train_encoder.draw_batch`` with
wrappers that record spans and count steps, and calls ``main``. The first
``warm_steps`` steps are set-up; the window opens when the next batch's
draw starts, and closes at the end of the first step that completes
``--seconds`` or more after that. The step wrapper then raises
``WindowClosed``, which ends ``main``, once the steps compared below have
run as well.

``correct`` holds the program against the plain reference
(``reference/train.py``) at two places, each a few steps through the
tool's own call and feed:

- the start: the warm steps, the reference from the benchmark's own
  starting weights;
- the window: ``compare_steps`` steps from the first step to start half
  a window or more after the window opened. The wrapper keeps the
  parameters and AdamW's moments before them (one copy on the device);
  the reference follows from that state.

Each compares every step's loss, each leaf's gradient of the first step
(from AdamW's first moment before and after it) and each leaf's change
over the steps. Every drawn batch is held to what the seeded table says
it should hold (``reference/draw.py``); the reference trains on the
batches rebuilt there, and the FLOPs are counted from their tokens.

What is specific to the model (its starting leaves, the hand-over to the
program, the map from a reference leaf to the program's parameter, the
reference's loss of a batch and a step's FLOPs) comes from the family
module of the configuration's ``model_type`` (``families/``).
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from functools import partial
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import families
from ..bench import Outcome
from ..gen.corpus import make_corpus, vocabulary
from ..hooks import Hooks
from ..profiling import DeviceProfile
from ..reference.bert import no_tf32
from ..reference.draw import DrawCheck
from ..reference.tokenizer import Tokenizer
from ..reference.train import run_steps
from ..roofline import H100_SXM


class WindowClosed(Exception):
    """Raised by the step wrapper to end the tool's loop after the window."""


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


class Tracker:
    def __init__(self, warm: int, compare: int, seconds: float, profile_steps: int,
                 port_name: Callable[[str], Tuple[str, bool]]):
        self.warm, self.compare, self.seconds = warm, compare, seconds
        self.profile_steps = profile_steps
        self.port_name = port_name  # the family's: reference leaf -> (program name, transposed)
        self.losses: List[float] = []
        self.batches: List[Dict] = []
        self.start: Dict[str, Dict[str, float]] = {}  # grad0, change of the warm steps
        self.t0: Optional[int] = None
        self.t1: Optional[int] = None
        self.window_steps = 0
        self.paused = 0  # ns of the window the profiler's stop took
        self.prof: Optional[DeviceProfile] = None
        # the window's compared steps: flat copies in the model's parameter order
        self.names: List[str] = []
        self.shapes: List[torch.Size] = []
        self.snap_step: Optional[int] = None
        self.snap: Dict[str, torch.Tensor] = {}

    def elapsed(self, t: int) -> int:
        return t - self.t0 - self.paused

    def moments(self, state, key: str) -> List[torch.Tensor]:
        opt = state.optimizer.state
        return [opt[p][key] if p in opt else torch.zeros_like(p)
                for p in state.model.parameters()]

    def leaf_norms(self, flat: torch.Tensor) -> Dict[str, float]:
        parts = torch.split(flat, [int(np.prod(s)) for s in self.shapes])
        norms = torch.stack([torch.linalg.vector_norm(x) for x in parts]).tolist()
        return dict(zip(self.names, norms))


def _install(hooks: Hooks, tr: Tracker, w0: Dict[str, np.ndarray], trace: bool, plant):
    from rag_icd10_tpu_torch.parallel import train as ptrain
    from rag_icd10_tpu_torch.tools import train_encoder

    names = {tr.port_name(k)[0]: (k, tr.port_name(k)[1]) for k in w0}

    def make_step(orig_make):
        def patched(*a, **kw):
            real = orig_make(*a, **kw)
            if plant is not None:
                real = plant("step", real)

            def step(state, batch):
                i = len(tr.losses)
                if (tr.snap_step is None and tr.t0 is not None
                        and tr.elapsed(time.time_ns()) >= tr.seconds * 5e8):
                    params = list(state.model.parameters())
                    tr.names = [n for n, _ in state.model.named_parameters()]
                    tr.shapes = [p.shape for p in params]
                    tr.snap_step = i
                    tr.snap = {"p0": _flat(params), "m0": _flat(tr.moments(state, "exp_avg")),
                               "v0": _flat(tr.moments(state, "exp_avg_sq"))}
                with hooks.span("step"):
                    m = real(state, batch)
                    loss = float(m["loss"])
                t1 = time.time_ns()
                tr.losses.append(loss)
                i += 1
                if i == 1:  # AdamW's first moment after one step is 0.1 x the gradient
                    opt = state.optimizer.state
                    tr.start["grad0"] = {
                        n: float(torch.linalg.vector_norm(opt[p]["exp_avg"])) / 0.1
                        for n, p in state.model.named_parameters() if p in opt}
                if i == tr.warm:  # the change over the warm steps
                    tr.start["change"] = {}
                    for n, p in state.model.named_parameters():
                        k, transposed = names[n]
                        ref = torch.from_numpy(w0[k].T if transposed else w0[k]).to(p.device)
                        tr.start["change"][n] = float(torch.linalg.vector_norm(p.detach() - ref))
                if tr.snap_step is not None:
                    if i == tr.snap_step + 1:
                        tr.snap["m1"] = _flat(tr.moments(state, "exp_avg"))
                    if i == tr.snap_step + tr.compare:
                        tr.snap["p1"] = _flat(state.model.parameters())
                if tr.t0 is not None and tr.t1 is None:
                    tr.window_steps += 1
                    if tr.prof is not None and tr.window_steps == tr.profile_steps:
                        t = time.time_ns()
                        tr.prof.stop()  # its seconds are not the program's
                        tr.paused += time.time_ns() - t
                    if tr.elapsed(t1) >= tr.seconds * 1e9:
                        tr.t1 = t1
                        hooks.recording = False
                if tr.t1 is not None and "p1" in tr.snap:
                    raise WindowClosed
                return m
            return step
        return patched

    def draw(orig):
        def wrapper(*a, **kw):
            if tr.t0 is None and len(tr.losses) == tr.warm:
                if trace:
                    tr.prof = DeviceProfile()
                    tr.prof.start()
                    hooks.recording = True
                tr.t0 = time.time_ns()
            with hooks.span("draw"):
                batch = orig(*a, **kw)
            if plant is not None:
                batch = plant("draw", batch)
            tr.batches.append(batch)
            return batch
        return wrapper

    hooks.wrap(ptrain, "make_train_step", make_step)
    hooks.wrap(train_encoder, "draw_batch", draw)


def job_argv(cell, hand_over: List[str], out: Path, seed: int) -> List[str]:
    """The job's command line: the traffic's loop, the configuration's
    recipe, the family's hand-over of the starting weights, the
    benchmark's files."""
    t = cell.config["train"]
    return list(cell.traffic["argv"]) + [
        "--seq-a", str(t["seq_a"]), "--seq-b", str(t["seq_b"]), "--lr", str(t["peak_lr"]),
        "--augment-prob", str(t["augment_prob"]), "--marker-prob", str(t["marker_prob"]),
        "--cousin-frac", str(t["cousin_frac"]), "--ancestor-frac", str(t["ancestor_frac"]),
        *hand_over, "--out", str(out), "--seed", str(abs(seed))]


def train_window(cell, seed: int, seconds: float, trace: bool, device="cuda", plant=None):
    """Set up, run the tool's loop through the window. Returns
    (tracker, inputs dict, memory peak)."""
    from rag_icd10_tpu_torch import config as pconfig
    from rag_icd10_tpu_torch.tools import train_encoder

    cfg, traffic = cell.config, cell.traffic
    family = families.of(cfg)
    tmp = Path(tempfile.mkdtemp(prefix="perfbench-"))
    hooks = Hooks()
    orig_get_config = pconfig.get_config
    try:
        st = cfg["store"]
        corpus = make_corpus(st["table_seed"], tuple(st["level_counts"]), st["combo_rows"])
        csv = tmp / "icd10.csv"
        corpus.write_csv(str(csv))
        init = tmp / "init"
        init.mkdir()
        (init / "vocab.txt").write_text("\n".join(vocabulary()), encoding="utf-8")
        w0 = family.start_leaves(cfg, seed, device)
        hand_over = family.hand_over(cfg, w0, init)
        for k in ("EMBEDDING_VOCAB_PATH", "EMBEDDING_WEIGHTS_PATH"):
            os.environ.pop(k, None)
        os.environ["ICD_DATA_PATH"] = str(csv)
        pc = orig_get_config()
        if family.program_config(cfg, pc) != pc:  # a narrowed configuration (the harness's tests)
            pconfig.get_config = lambda: family.program_config(cfg, orig_get_config())
        tr = Tracker(int(cfg["train"]["warm_steps"]), int(cfg["train"]["compare_steps"]),
                     seconds, int(traffic["profile_steps"]), family.port_name)
        _install(hooks, tr, w0, trace, plant)
        try:
            train_encoder.main(job_argv(cell, hand_over, tmp / "out", seed), device=device)
        except WindowClosed:
            pass
        if tr.prof is not None and tr.prof.t1 == 0:
            tr.prof.stop()
        if tr.prof is not None:
            tr.prof.read()
    finally:
        hooks.restore()
        pconfig.get_config = orig_get_config
        shutil.rmtree(tmp, ignore_errors=True)
    memory_peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return tr, {"w0": w0, "hooks": hooks, "corpus": corpus}, memory_peak


def rebuild(cell, tr: Tracker, corpus):
    """Every drawn batch held to the seeded table: (faults, the batches
    the reference trains on, their rows' token counts)."""
    t = cell.config["train"]
    check = DrawCheck(corpus, Tokenizer(vocabulary()), int(t["seq_a"]), int(t["seq_b"]),
                      cell.config["store"]["level_weights"], float(t["cousin_frac"]),
                      float(t["ancestor_frac"]))
    rebuilt = [check.check(b) for b in tr.batches]
    faults = dict(check.faults)
    return faults, [r for r, _ in rebuilt], [c for _, c in rebuilt]


def compare(prog_losses, prog_grad0, prog_change, ref, w0_names,
            port_name: Callable[[str], Tuple[str, bool]]) -> Dict[str, float]:
    """Widest gaps of the program's numbers against the reference's; the
    gradients and changes by leaf, each against the larger of the leaf's
    own reference norm and the median leaf's."""
    names = {port_name(k)[0]: k for k in w0_names}
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, ref["losses"]))
    g_ref = {n: ref["grad0"][k] for n, k in names.items()}
    c_ref = {n: ref["change"][k] for n, k in names.items()}
    g_med = float(np.median(list(g_ref.values())))
    c_med = float(np.median(list(c_ref.values())))
    grad_gap = max(abs(prog_grad0.get(n, 0.0) - g) / max(g, g_med) for n, g in g_ref.items())
    # leaves whose gradient is nought to rounding (a key's bias under
    # softmax) move under Adam by round-off alone: left out by this rule
    moved = [n for n in c_ref if g_ref[n] >= 1e-3 * g_med]
    change_gap = max(abs(prog_change.get(n, 0.0) - c_ref[n]) / max(c_ref[n], c_med)
                     for n in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def left_out(ref) -> List[str]:
    med = float(np.median(list(ref["grad0"].values())))
    return sorted(k for k, g in ref["grad0"].items() if g < 1e-3 * med)


def snapshot_leaves(tr: Tracker, w0_names, key: str) -> Dict[str, torch.Tensor]:
    """A flat copy as the benchmark's leaves (Dense kernels (in, out))."""
    parts = torch.split(tr.snap[key], [int(np.prod(s)) for s in tr.shapes])
    by_port = {n: x.view(s) for n, x, s in zip(tr.names, parts, tr.shapes)}
    out = {}
    for k in w0_names:
        n, transposed = tr.port_name(k)
        out[k] = by_port[n].T.contiguous() if transposed else by_port[n].clone()
    return out


def program_window(tr: Tracker):
    """The program's numbers of the window's compared steps."""
    s = tr.snap_step
    grad0 = tr.leaf_norms((tr.snap["m1"] - 0.9 * tr.snap["m0"]) / 0.1)
    change = tr.leaf_norms(tr.snap["p1"] - tr.snap["p0"])
    return tr.losses[s:s + tr.compare], grad0, change


def reference_runs(cfg, tr: Tracker, w0, batches, device, rnd=None, half=False):
    """The reference over the start's and the window's compared steps
    (``rnd``: the control; ``half``: half of each batch, a planted fault)."""
    no_tf32()
    t, k = cfg["train"], tr.compare
    loss = partial(families.of(cfg).loss, cfg)

    def use(bs):
        if not half:
            return bs
        return [{key: np.asarray(v)[: np.asarray(v).shape[0] // 2] for key, v in b.items()}
                for b in bs]

    def steps(w, bs, moments=None, start=0):
        return run_steps(w, use(bs), loss, t["peak_lr"], t["warmup_steps"], t["decay_steps"],
                         t["weight_decay"], rnd=rnd, moments=moments, start=start)

    out = {"start": steps({key: torch.from_numpy(v).to(device) for key, v in w0.items()},
                          batches[:tr.warm])}
    gc.collect()
    s = tr.snap_step
    moments = (snapshot_leaves(tr, w0, "m0"), snapshot_leaves(tr, w0, "v0"))
    out["window"] = steps(snapshot_leaves(tr, w0, "p0"), batches[s:s + k], moments, s)
    del moments
    gc.collect()
    return out


def numbers(tr: Tracker, w0, ref) -> Dict[str, float]:
    out = {}
    start = compare(tr.losses[:tr.warm], tr.start.get("grad0", {}),
                    tr.start.get("change", {}), ref["start"], w0, tr.port_name)
    window = compare(*program_window(tr), ref["window"], w0, tr.port_name)
    out.update(start)
    out.update({f"window_{k}": v for k, v in window.items()})
    return out


def run(cell, seed: int, seconds: float, trace: bool, t_start_ns: int, device="cuda",
        plant=None) -> Outcome:
    cfg = cell.config
    tr, inp, memory_peak = train_window(cell, seed, seconds, trace, device, plant)
    w0, warm = inp["w0"], tr.warm
    rows = int(np.asarray(tr.batches[0]["a_ids"]).shape[0]) if tr.batches else 0
    t_check = time.time()
    faults, batches, counts = rebuild(cell, tr, inp["corpus"])
    t_rebuilt = time.time()
    step_flops = families.of(cfg).step_flops
    flops = sum(step_flops(*c, cfg) for c in counts[warm:warm + tr.window_steps])
    window_s = (tr.t1 - tr.t0 - tr.paused) / 1e9 if tr.t1 and tr.t0 else 0.0
    checks = {"draw_faults": float(sum(faults.values())),
              "nonfinite_loss": float(sum(not np.isfinite(x) for x in tr.losses))}
    done = (len(tr.losses) >= warm and tr.t1 is not None and "p1" in tr.snap
            and "change" in tr.start)
    checks["compared"] = float(not done)
    notes = []
    if done and not faults:
        ref = reference_runs(cfg, tr, w0, batches, device)
        read = numbers(tr, w0, ref)
        checks.update(read)
        notes.append("numbers read: " + ", ".join(f"{k} {v}" for k, v in read.items()))
        notes.append(f"compared in {time.time() - t_check:.1f} s (the draw "
                     f"{t_rebuilt - t_check:.1f} s, the reference the rest)")
        notes.append("leaves left out of the change (reference gradient under 1e-3 of the "
                     "median leaf's): start " + ", ".join(left_out(ref["start"]))
                     + "; window " + ", ".join(left_out(ref["window"])))
    lim = cell.limits
    data = {"setup_s": (tr.t0 - t_start_ns) / 1e9 if tr.t0 else None, "window_s": window_s,
            "window_samples": tr.window_steps * rows, "window_flops": flops,
            "peak_flops": H100_SXM["bf16_flops"], "spans": dict(inp["hooks"].spans),
            "profile": tr.prof if (tr.prof is not None and tr.prof.error is None) else None}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if data["profile"] is not None:
        p = data["profile"]
        dev["busy_s"], dev["window_s"] = p.busy_s(), p.window_s
        breakdown = {"device_ops": p.top_ops(), "idle_gaps": p.idle_gaps(data["spans"])}
        notes.append(p.summary(data["spans"]))
    elif tr.prof is not None:
        notes.append("profiler: " + str(tr.prof.error))
    if inp["hooks"].missing:
        notes.append("hook points missing: " + ", ".join(inp["hooks"].missing))
    if faults:
        notes.append(f"draw faults by kind: {faults}")
    notes.append(f"steps: {warm} warm, {tr.window_steps} in the window, compared from step "
                 f"{tr.snap_step}; losses {tr.losses[:warm]} ... "
                 f"{tr.losses[tr.snap_step or 0:(tr.snap_step or 0) + tr.compare]}")
    return Outcome(data=data, attempted=tr.window_steps,
                   failed=int(sum(not np.isfinite(x) for x in tr.losses[warm:])),
                   checks={k: {"value": checks.get(k, float("nan")), "limit": float(lim[k])}
                           for k in lim},
                   device=dev, breakdown=breakdown, notes=notes)
