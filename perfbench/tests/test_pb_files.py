"""BENCHMARK.json and the files it names keep to the benchmark's rules."""

import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import bench
from perfbench.tests.pb_tiny import ROOT

PB_FILE = ROOT / "BENCHMARK.json"


def benchmark():
    return bench.load_json(PB_FILE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PB = ROOT / "perfbench"


def test_top_level_keys():
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    assert all(isinstance(w, str) and 1 <= len(w) <= 200 for w in b["command"])
    assert len(json.dumps(b).encode()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    entries = benchmark()[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and section != "per_layer" or key in ("why", "layer"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_cells_and_metrics_resolve():
    b = benchmark()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for w in b["workloads"]:
        cell = bench.Cell.find(b, w["name"])
        assert w["chips"] == 1
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        reported = {m["name"] for m in cell.end_to_end}
        for m in cell.per_layer:
            assert m["moves"] in reported
    for m in b["end_to_end"] + b["per_layer"]:
        spec = bench.load_json(PB / "metrics" / f"{m['name']}.json")
        assert (PB / "readers" / f"{spec['reader']}.py").exists()
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_metric_files_and_names_use_allowed_characters():
    for path in PB.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT))), path
    for path in (PB / "metrics").glob("*.json"):
        assert NAME.match(path.stem)


EXPERTS = ("n_routed_experts", "num_experts", "num_local_experts")


def cut_faults(entry: dict, root: Path = ROOT) -> list:
    """What parts configuration ``entry`` of the benchmark at ``root`` from
    its source: its published values (``perfbench/published/<name>.json``)
    must all be in its file, but for the keys in ``reduced``, and those
    may only be the cuts that leave the model itself, each at its floor:
    dropout rates; depth, to the leading dense layers plus 4; the experts
    held, to min(8, published), as one chip's share of a layer split over
    several; the vocabulary, to an eighth of its rows. No width is cut. A
    cut of the experts or the vocabulary names the ``deployment`` it
    stands for."""
    path = root / "perfbench" / "published" / f"{entry['name']}.json"
    if not path.exists():
        return [f"no published file {path.name}"]
    pub, cfg = bench.load_json(path), bench.load_json(root / entry["file"])
    changed = {k for k, v in pub.items() if k not in cfg or cfg[k] != v}
    faults = []
    if changed != set(entry["reduced"]):
        faults.append(f"changed {sorted(changed)}, reduced {sorted(entry['reduced'])}")
    for k in sorted(changed):
        v, was = cfg.get(k), pub[k]
        if k.endswith("_dropout_prob"):
            continue
        if k == "num_hidden_layers":
            floor = pub.get("first_k_dense_replace", 0) + 4
        elif k in EXPERTS:
            floor = min(8, was)
        elif k == "vocab_size":
            floor = -(-was // 8)
        else:
            faults.append(f"{k} is not a cut that leaves the model")
            continue
        if not (isinstance(v, int) and floor <= v <= was):
            faults.append(f"{k} {v} outside [{floor}, {was}]")
        if k != "num_hidden_layers" and not cfg.get("deployment"):
            faults.append(f"{k} cut with no deployment")
    return faults


@pytest.mark.parametrize("entry", benchmark()["configs"], ids=lambda c: c["name"])
def test_config_files_hold_the_source_but_for_reduced(entry):
    assert cut_faults(entry) == []


# a deepseek_v3-shaped source (Moonlight-16B-A3B's published config.json values)
DSV3 = {"attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
        "hidden_size": 2048, "intermediate_size": 11264, "kv_lora_rank": 512,
        "max_position_embeddings": 8192, "model_type": "deepseek_v3",
        "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
        "n_routed_experts": 64, "n_shared_experts": 2, "norm_topk_prob": True,
        "num_attention_heads": 16, "num_experts_per_tok": 6, "num_hidden_layers": 27,
        "num_key_value_heads": 16, "q_lora_rank": None, "qk_nope_head_dim": 128,
        "qk_rope_head_dim": 64, "rms_norm_eps": 1e-05, "rope_theta": 50000,
        "routed_scaling_factor": 2.446, "scoring_func": "sigmoid", "topk_group": 1,
        "topk_method": "noaux_tc", "v_head_dim": 128, "vocab_size": 163840}
DSV3_CUTS = {"n_routed_experts": 8, "vocab_size": 21128, "num_hidden_layers": 5}
DROPOUT = ["hidden_dropout_prob", "attention_probs_dropout_prob"]


def _faults_of_copy(tmp_path, name, change, reduced, published=True):
    """``cut_faults`` of configuration ``name`` in a copy of the benchmark,
    its file changed by ``change``; ``dsv3-embed`` is a new configuration
    over ``DSV3``, cut by ``DSV3_CUTS`` for eight chips."""
    pb = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", pb, ignore=shutil.ignore_patterns("__pycache__"))
    if name == "dsv3-embed":
        cfg = dict(DSV3, **DSV3_CUTS, deployment="each layer's 64 experts and the vocabulary "
                   "over 8 chips; this chip holds 8 experts and 21,128 rows")
        if published:
            (pb / "published" / f"{name}.json").write_text(json.dumps(DSV3))
    else:
        cfg = bench.load_json(pb / "configs" / f"{name}.json")
        if not published:
            (pb / "published" / f"{name}.json").unlink()
    change(cfg)
    (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    entry = {"name": name, "file": f"perfbench/configs/{name}.json", "reduced": reduced}
    return cut_faults(entry, tmp_path)


def _set(**kv):
    return lambda cfg: cfg.update(kv)


@pytest.mark.parametrize("name,change,reduced", [
    ("text2vec-finetune", _set(hidden_size=384), DROPOUT + ["hidden_size"]),
    ("text2vec-finetune", _set(num_hidden_layers=6), DROPOUT),
    ("text2vec-finetune", _set(vocab_size=2000), DROPOUT + ["vocab_size"]),
    ("dsv3-embed", _set(n_routed_experts=4), list(DSV3_CUTS)),
    ("dsv3-embed", _set(num_hidden_layers=4), list(DSV3_CUTS)),
    ("dsv3-embed", _set(num_experts_per_tok=2), list(DSV3_CUTS) + ["num_experts_per_tok"]),
    ("dsv3-embed", _set(moe_intermediate_size=704), list(DSV3_CUTS) + ["moe_intermediate_size"]),
    ("dsv3-embed", lambda cfg: cfg.pop("deployment"), list(DSV3_CUTS)),
    ("dsv3-embed", lambda cfg: cfg.pop("rope_theta"), list(DSV3_CUTS)),
], ids=["hidden_size", "unlisted", "vocab_under_an_eighth", "experts_under_8",
        "depth_under_dense_plus_4", "experts_per_token", "expert_width", "no_deployment",
        "key_left_out"])
def test_a_cut_outside_the_rule_fails(tmp_path, name, change, reduced):
    assert _faults_of_copy(tmp_path, name, change, reduced)


@pytest.mark.parametrize("name", ["text2vec-finetune", "dsv3-embed"])
def test_a_configuration_without_its_published_file_fails(tmp_path, name):
    assert _faults_of_copy(tmp_path, name, _set(), [], published=False)


def test_the_allowed_cuts_at_their_floors_pass(tmp_path):
    assert _faults_of_copy(tmp_path, "dsv3-embed", _set(), list(DSV3_CUTS)) == []
