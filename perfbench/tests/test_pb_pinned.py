"""The narrowed CPU cell hands the program what the harness of commit
60f0fb0 handed it, and reads the same reference numbers and FLOPs, for
one seed: the model-specific parts moved behind ``families/`` with no
change to what they compute.

``pinned_tiny.json`` was recorded by ``capture`` on that commit (its
``roofline.train_step_flops`` in place of the family's ``step_flops``):
the handed-over ``params.npz`` (each member's bytes; the archive itself
carries the time it was written), the program's argv with the run's
temporary directory as ``<tmp>``, the sizes the program's encoder config
was narrowed to, and, over the batches the program drew at this seed
(their digest pinned too), each batch's FLOPs and the reference's losses,
first gradient norms and changes over the warm steps, with the start's
gaps of the program against it. One thread, since a CPU product's
rounding follows how it is split across threads.
"""

import hashlib
import json
import zipfile
from pathlib import Path

import numpy as np
import torch

from perfbench.drivers import train
from perfbench.tests.pb_tiny import tiny_cell

SEED = 2**31 + 7
PINNED = Path(__file__).with_name("pinned_tiny.json")
NARROWED = ("hidden_size", "num_layers", "num_heads", "intermediate_size", "vocab_size",
            "max_position_embeddings", "type_vocab_size", "layer_norm_eps")


def capture(step_flops=None) -> dict:
    from rag_icd10_tpu_torch import config as pconfig
    from rag_icd10_tpu_torch.tools import train_encoder

    cell = tiny_cell()
    if step_flops is None:
        from perfbench import families
        step_flops = families.of(cell.config).step_flops
    out = {}
    main = train_encoder.main

    def spy(argv, device="cpu"):
        npz = Path(argv[argv.index("--init-from") + 1])
        with zipfile.ZipFile(npz) as z:
            out["npz"] = {n: hashlib.sha256(z.read(n)).hexdigest() for n in sorted(z.namelist())}
        tmp = str(npz.parent.parent)
        out["argv"] = [a.replace(tmp, "<tmp>") for a in argv]
        enc = pconfig.get_config().encoder
        out["encoder"] = {k: getattr(enc, k) for k in NARROWED}
        return main(argv, device=device)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    train_encoder.main = spy
    try:
        tr, inp, _ = train.train_window(cell, SEED, 1.0, False, "cpu")
    finally:
        train_encoder.main = main
    try:
        digest = hashlib.sha256()
        for b in tr.batches[:6]:
            for k in sorted(b):
                digest.update(k.encode() + np.ascontiguousarray(b[k]).tobytes())
        out["drawn"] = digest.hexdigest()
        faults, batches, counts = train.rebuild(cell, tr, inp["corpus"])
        out["faults"] = faults
        out["flops"] = [step_flops(*c, cell.config) for c in counts[:6]]
        ref = train.reference_runs(cell.config, tr, inp["w0"], batches, "cpu")
        out["start"] = ref["start"]
        gaps = train.numbers(tr, inp["w0"], ref)
        out["start_gaps"] = {k: v for k, v in gaps.items() if not k.startswith("window_")}
    finally:
        torch.set_num_threads(threads)
    return out


def test_change_reproduces_the_parent():
    got = json.loads(json.dumps(capture()))
    want = json.loads(PINNED.read_text())
    for key in ("npz", "argv", "encoder", "drawn", "faults", "flops", "start", "start_gaps"):
        assert got[key] == want[key], key
