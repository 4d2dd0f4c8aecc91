"""One module a published ``model_type``, found by the configuration's own
``model_type`` key (``bert`` -> ``families/bert.py``; a character that
cannot stand in a module's name becomes ``_``).

A family module gives the training cell (``drivers/train.py``) what is
specific to a model:

- ``start_leaves(cfg, seed, device)``: the seeded starting leaves in the
  reference's layout, as host arrays;
- ``hand_over(cfg, w0, init)``: writes the program's starting files into
  the directory ``init`` and returns the arguments that name them;
- ``program_config(cfg, pc)``: the program's own config ``pc``, narrowed
  to ``cfg``'s sizes where they differ from the program's defaults (the
  harness's narrowed test cells), else ``pc`` itself;
- ``port_name(leaf)``: the program's parameter name of a reference leaf,
  and whether the program holds it transposed;
- ``loss(cfg, w, batch, rnd=None)``: the reference's loss of one batch
  from its leaves ``w`` (``rnd``: the control's rounding);
- ``step_flops(a_tokens, b_tokens, h_tokens, cfg)``: one step's FLOPs
  from its rows' non-padding token counts.
"""

import importlib
import re


def of(cfg):
    """The family module of configuration ``cfg``."""
    module = re.sub(r"[^A-Za-z0-9_]", "_", cfg["model_type"])
    return importlib.import_module(f"{__name__}.{module}")
