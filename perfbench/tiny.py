"""Small stand-ins of the benchmark's configurations and traffic, for the
tests on the CPU: the same files, keys and code paths at widths a test
run holds. :func:`tiny_root` writes a checkout-like directory (a copy of
``perfbench/`` and a ``BENCHMARK.json``) whose cells run them."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

DENSE = {
    "name": "tiny-dense",
    "num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "ffn_dim": 128,
    "vocab_size": 512, "max_position_embeddings": 256, "enable_bias": True,
    "tie_word_embeddings": True, "gated_mlp": False,
    "activation_function": "gelu_tanh", "rope_theta": 10000.0,
    "rms_norm_eps": 1e-05, "sliding_window": None,
    "torch_dtype": "float32",
    "reference": "dense_gqa",
    "port": {"arch_id": "paper-opt-13b",
             "replace": {"num_layers": 2, "d_model": 64, "num_heads": 4,
                         "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
                         "vocab_size": 512, "max_seq_len": 256,
                         "dtype": "float32"},
             "equal": {"num_layers": "num_hidden_layers",
                       "d_model": "hidden_size",
                       "num_heads": "num_attention_heads",
                       "num_kv_heads": "num_key_value_heads",
                       "head_dim": "head_dim", "d_ff": "ffn_dim",
                       "vocab_size": "vocab_size",
                       "max_seq_len": "max_position_embeddings",
                       "use_bias": "enable_bias", "gated_mlp": "gated_mlp",
                       "rope_theta": "rope_theta",
                       "norm_eps": "rms_norm_eps",
                       "sliding_window": "sliding_window",
                       "dtype": "torch_dtype"}},
    "engine": {"num_pages": 96, "page_size": 8, "max_slots": 4,
               "max_tokens_per_iter": 64, "chunk_policy": "decode_first",
               "enable_prefix_cache": False},
    "check": {"limits": {"max_logit_gap": 0.05}, "sample_tokens": 48},
}

MLA = {
    "name": "tiny-mla",
    "num_hidden_layers": 3, "hidden_size": 64, "num_attention_heads": 4,
    "num_key_value_heads": 4, "intermediate_size": 128, "vocab_size": 512,
    "kv_lora_rank": 32, "q_lora_rank": 48, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "n_routed_experts": 8,
    "n_shared_experts": 1, "num_experts_per_tok": 2,
    "moe_intermediate_size": 32, "first_k_dense_replace": 1,
    "norm_topk_prob": True, "routed_scaling_factor": 1.0,
    "topk_method": "greedy", "rms_norm_eps": 1e-05, "rope_theta": 10000,
    "attention_bias": False, "gated_mlp": True, "capacity_factor": 4.5,
    "torch_dtype": "float32",
    "reference": "mla_moe",
    "port": {"arch_id": "deepseek-v2-236b",
             "replace": {"num_layers": 3, "d_model": 64, "num_heads": 4,
                         "num_kv_heads": 4, "head_dim": 16, "d_ff": 128,
                         "vocab_size": 512, "kv_lora_rank": 32,
                         "q_lora_rank": 48, "qk_nope_head_dim": 16,
                         "qk_rope_head_dim": 8, "v_head_dim": 16,
                         "num_experts": 8, "num_shared_experts": 1,
                         "moe_top_k": 2, "moe_d_ff": 32,
                         "capacity_factor": 4.5, "dtype": "float32"},
             "equal": {"num_layers": "num_hidden_layers",
                       "d_model": "hidden_size",
                       "num_heads": "num_attention_heads",
                       "d_ff": "intermediate_size",
                       "vocab_size": "vocab_size",
                       "kv_lora_rank": "kv_lora_rank",
                       "q_lora_rank": "q_lora_rank",
                       "qk_nope_head_dim": "qk_nope_head_dim",
                       "qk_rope_head_dim": "qk_rope_head_dim",
                       "v_head_dim": "v_head_dim",
                       "num_experts": "n_routed_experts",
                       "num_shared_experts": "n_shared_experts",
                       "moe_top_k": "num_experts_per_tok",
                       "moe_d_ff": "moe_intermediate_size",
                       "first_k_dense": "first_k_dense_replace",
                       "capacity_factor": "capacity_factor",
                       "norm_eps": "rms_norm_eps",
                       "dtype": "torch_dtype"}},
    "engine": {"num_pages": 96, "page_size": 8, "max_slots": 4,
               "max_tokens_per_iter": 64, "chunk_policy": "decode_first",
               "enable_prefix_cache": False},
    "check": {"limits": {"max_logit_gap": 0.05}, "sample_tokens": 48},
}

TRAFFIC = {
    "loop": "closed", "sessions": 4, "think_s": 0.0,
    "prompt": {"median": 20, "sigma": 0.9, "min": 4, "max": 60},
    "output": {"median": 8, "sigma": 0.7, "min": 2, "max": 16},
    "strata": 8, "warmup_s": 0.3, "profile_s": 0.3,
}


def bf16(conf: dict) -> dict:
    """``conf`` served in bfloat16."""
    c = copy.deepcopy(conf)
    c["torch_dtype"] = "bfloat16"
    c["port"]["replace"]["dtype"] = "bfloat16"
    return c


def widen(conf: dict, d_model: int, vocab: int, tokens: int) -> dict:
    """``conf`` at another model width and vocabulary, comparing
    ``tokens`` served tokens."""
    c = copy.deepcopy(conf)
    c["hidden_size"], c["vocab_size"] = d_model, vocab
    c["port"]["replace"].update(d_model=d_model, vocab_size=vocab)
    c["check"]["sample_tokens"] = tokens
    return c


def tiny_root(dest: Path, confs=(DENSE, MLA), traffic=TRAFFIC) -> Path:
    """A copy of ``perfbench/`` under ``dest`` with the tiny configurations
    and mix and a ``BENCHMARK.json`` holding one cell of each:
    ``<config name>.tiny``."""
    dest = Path(dest)
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"], doc["workloads"] = [], []
    for conf in confs:
        f = f"perfbench/configs/{conf['name']}.json"
        (dest / f).write_text(json.dumps(conf))
        doc["configs"].append({"name": conf["name"], "source": "tiny",
                               "file": f, "reduced": [], "why": "tests"})
        doc["workloads"].append({"name": conf["name"] + ".tiny",
                                 "config": conf["name"], "traffic": "tiny",
                                 "chips": 1, "why": "tests"})
    (dest / "perfbench/traffic/tiny.json").write_text(json.dumps(traffic))
    for m in doc["per_layer"] + doc["end_to_end"]:
        m.pop("workloads", None)
    (dest / "BENCHMARK.json").write_text(json.dumps(doc))
    return dest
