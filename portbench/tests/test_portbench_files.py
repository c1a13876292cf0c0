"""The benchmark's files: ``BENCHMARK.json`` against the contract's
shape, every name it gives found as a file, and a new configuration,
cell and per-layer metric taken up as new files alone."""

from __future__ import annotations

import json
import re

import pytest
import torch

from portbench_smoke import ROOT, smoke_tree

from portbench.harness.cell import run_cell
from portbench.harness.files import Files

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

#: DeepSeek-V2-Lite's ``config`` as the architecture catalog reads it from
#: https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json
DEEPSEEK_V2_LITE = {
    "attention_bias": False, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 10944,
    "kv_lora_rank": 512, "max_position_embeddings": 163840,
    "model_type": "deepseek_v2", "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16, "q_lora_rank": None,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1,
    "scoring_func": "softmax", "seq_aux": True, "tie_word_embeddings": False,
    "topk_group": 1, "topk_method": "greedy", "v_head_dim": 128,
    "vocab_size": 102400}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_has_the_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in bench[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    layers = {m["layer"] for m in bench["per_layer"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] == "train_tokens_per_s"
        assert m["layer"] in layers
    assert all(w["chips"] == 1 for w in bench["workloads"])


def test_every_name_is_a_file(bench):
    files = Files()
    used = set()
    for w in bench["workloads"]:
        spec = files.workload(w["name"])
        assert spec["config"] == w["config"]
        used.add(w["config"])
        cfg = files.config(spec["config"])
        files.traffic(spec["traffic"])
        fam = files.family(cfg["family"])
        assert fam.layout(cfg)
        assert set(spec["limits"]) == {"loss", "grad", "update"}
        reported = files.per_layer(w["name"])
        assert reported and len(files.end_to_end(w["name"])) >= 2
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["name"] in used
    for m in bench["per_layer"]:
        assert callable(files.metric(m["name"]).read)


def test_deepseek_file_holds_the_catalog_numbers():
    """The file no cell runs yet still holds the catalog's numbers but
    those it lists as changed, and states only what the program runs."""
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "deepseek-v2-lite-16b.json").read_text())
    changed = {k for k, v in DEEPSEEK_V2_LITE.items() if cfg.get(k) != v}
    assert changed == set(cfg["reduced"]) == {
        "num_hidden_layers", "norm_topk_prob", "rope_scaling", "seq_aux"}
    mla_moe = Files().family("mla_moe")
    for key, value in (("seq_aux", True), ("aux_loss_alpha", 0.01),
                       ("norm_topk_prob", False)):
        with pytest.raises(ValueError, match="the reference runs"):
            mla_moe.dims({**cfg, key: value})
    assert cfg["num_hidden_layers"] == 4
    published = {k: DEEPSEEK_V2_LITE[k] for k in changed}
    assert cfg["published"] == published


def test_a_new_config_cell_and_metric_are_new_files(tmp_path):
    """A configuration, a cell and a per-layer metric added as files (and
    named in BENCHMARK.json) run without an edit to any other file."""
    files = smoke_tree(tmp_path)
    bench = files.bench
    cfg = json.loads((bench / "configs" / "olmo-1b.json").read_text())
    cfg["num_hidden_layers"] = 3
    (bench / "configs" / "olmo-3l.json").write_text(json.dumps(cfg))
    spec = json.loads((bench / "workloads" / "olmo-1b.train.json")
                      .read_text())
    spec["config"] = "olmo-3l"
    (bench / "workloads" / "olmo-3l.train.json").write_text(
        json.dumps(spec))
    (bench / "metrics" / "window_steps.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    top = json.loads((tmp_path / "BENCHMARK.json").read_text())
    top["configs"].append({"name": "olmo-3l", "source": "test",
                           "file": "portbench/configs/olmo-3l.json",
                           "reduced": [], "why": "test"})
    top["workloads"].append({"name": "olmo-3l.train", "config": "olmo-3l",
                             "traffic": "train", "chips": 1, "why": "test"})
    top["per_layer"].append({"name": "window_steps", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "trainer",
                             "moves": "train_tokens_per_s",
                             "workloads": ["olmo-3l.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(top))
    out = run_cell(files, "olmo-3l.train", 7, 0.1, True,
                   torch.device("cpu"), 0.0)
    assert out["correct"]
    assert out["metrics"]["window_steps"]["value"] >= 1
    assert "window_steps" not in run_cell(
        files, "olmo-1b.train", 7, 0.1, True, torch.device("cpu"),
        0.0)["metrics"]
