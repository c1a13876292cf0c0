"""A copy of the benchmark's files at a size a CPU test can hold: the
same cells, limits and per-layer metrics, with every configuration's
widths, depth and vocabulary cut and the traffic's sequences shortened.
The tests of ``portbench/tests`` run the harness on it."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench.harness.files import Files  # noqa: E402

#: the cut of each family's sizes (its configuration file's keys)
SMOKE = {
    "dense": dict(hidden_size=64, intermediate_size=128,
                  num_attention_heads=4, num_key_value_heads=4,
                  num_hidden_layers=2, vocab_size=512),
    "mla_moe": dict(hidden_size=64, intermediate_size=160,
                    num_attention_heads=4, num_key_value_heads=4,
                    num_hidden_layers=3, vocab_size=512, kv_lora_rank=32,
                    qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
                    n_routed_experts=8, num_experts_per_tok=2,
                    moe_intermediate_size=64, n_shared_experts=1),
}


def smoke_tree(tmp: Path, dtype: str = "float32") -> Files:
    """The benchmark's files copied under ``tmp`` and cut to the smoke
    size, computing in ``dtype``."""
    bench = Path(tmp) / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", Path(tmp) / "BENCHMARK.json")
    for path in (bench / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(SMOKE[cfg["family"]])
        cfg["port"]["fields"].update(param_dtype=dtype, compute_dtype=dtype,
                                     loss_chunk=16)
        path.write_text(json.dumps(cfg))
    for path in (bench / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(seq_len=32, pool=5, global_batch=8)
        path.write_text(json.dumps(traffic))
    _moe_cell(bench, Path(tmp) / "BENCHMARK.json")
    return Files(bench)


#: a cell of the MoE family for the tests alone: DeepSeek-V2-Lite's file
#: and reference stay for a later cell, which no cell of the benchmark
#: runs yet
MOE_CELL = "deepseek-v2-lite-16b.train"


def _moe_cell(bench: Path, top_file: Path) -> None:
    spec = json.loads((bench / "workloads" / "olmo-1b.train.json")
                      .read_text())
    spec.update(config="deepseek-v2-lite-16b")
    (bench / "workloads" / f"{MOE_CELL}.json").write_text(json.dumps(spec))
    top = json.loads(top_file.read_text())
    top["configs"].append({"name": "deepseek-v2-lite-16b", "source": "test",
                           "file": "portbench/configs/"
                                   "deepseek-v2-lite-16b.json",
                           "reduced": [], "why": "test"})
    top["workloads"].append({"name": MOE_CELL,
                             "config": "deepseek-v2-lite-16b",
                             "traffic": "train", "chips": 1, "why": "test"})
    top["per_layer"].append({"name": "moe_dropped_share", "unit": "%",
                             "better": "lower", "source": "program_counter",
                             "layer": "MoE", "moves": "train_tokens_per_s",
                             "workloads": [MOE_CELL]})
    top_file.write_text(json.dumps(top))
