"""Tiny configurations and traffic for the CPU tests: the cells' kinds at
a size a test run holds, with the activations in f32 (the program then
matches the reference to rounding, so a sound run reads far under every
limit and a fault far over)."""
from __future__ import annotations

import functools
import time

import harness

TINY_LM = {"reference": "decoder", "arch": "smollm-135m",
           "hidden_size": 64, "intermediate_size": 96,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 16, "num_hidden_layers": 2, "vocab_size": 256,
           "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
           "tie_word_embeddings": True, "hidden_act": "silu",
           "activation_dtype": "float32", "remat": True, "z_loss": 1e-4,
           "tp_divisor": 1}
TINY_MOE = dict(TINY_LM, arch="olmoe-1b-7b", intermediate_size=32,
                num_experts=8, num_experts_per_tok=2, norm_topk_prob=True,
                qk_norm=True, qk_norm_scope="head",
                router_aux_loss_coef=0.01, router_z_loss_coef=0.01,
                moe_group_size=16, moe_capacity_factor=1.0)
TINY_TRAIN = {"kind": "train", "mesh": [2, 2, 1], "batch_per_vertex": 2,
              "seq": 32, "sync": "edst", "engine": "pipelined",
              "optimizer": {"lr": 3e-4, "warmup": 20, "total_steps": 1000,
                            "b1": 0.9, "b2": 0.95, "eps": 1e-8,
                            "weight_decay": 0.1, "clip_norm": 1.0},
              "warm_steps": 3, "ref_steps": 3, "ref_block": 2,
              "trace_steps": 1}
TINY_ALLREDUCE = {"kind": "allreduce", "mesh": [4, 4, 1],
                  "engine": "pipelined", "segments": "auto", "ranks": 1,
                  "warm_calls": 2, "trace_calls": 2}
SEED = 2 ** 31 + 11

# kind -> (a workload whose metrics and limits it takes, config, traffic)
TINY_RUNS = {
    "train": ("smollm-135m.train.edst", TINY_LM, TINY_TRAIN),
    "allreduce": ("smollm-135m.sync.edst", TINY_LM, TINY_ALLREDUCE),
}


def run_tiny(kind, config, traffic, name, trace=False, seconds=0.3,
             plant=None, seed=SEED):
    harness.program_path()
    mod = harness.load_kind(kind)
    return mod.run(None, config, traffic, harness.limits_for(name), seed,
                   seconds, trace, time.perf_counter(), device="cpu",
                   plant=plant)


@functools.lru_cache(maxsize=None)
def tiny_result(kind: str, trace: bool):
    """``(bench, workload, result)`` of one tiny CPU run of ``kind``."""
    name, config, traffic = TINY_RUNS[kind]
    return harness.load_benchmark(), name, run_tiny(kind, config, traffic,
                                                    name, trace)
