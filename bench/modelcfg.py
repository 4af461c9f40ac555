"""The configuration file as the program runs it.

A configuration file holds the model's published keys (Hugging Face
``config.json`` names) as it is run, and ``arch``, the program's own
configuration it starts from.  :func:`port_config` writes every size of
the file into that configuration, so the program runs what the file
states; where the program fixes a value in code (:data:`PORT_FIXED`),
the file must state that value, or the cell is refused before it runs.
"""
from __future__ import annotations

import dataclasses

# the file's keys -> the program's ArchConfig fields
FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv", "head_dim": "head_dim",
          "vocab_size": "vocab", "rope_theta": "rope_theta",
          "num_experts": "n_experts", "num_experts_per_tok": "top_k",
          "moe_group_size": "moe_group_size",
          "moe_capacity_factor": "moe_capacity_factor",
          "router_aux_loss_coef": "aux_loss_weight", "remat": "remat"}

# what the program computes whatever its configuration says: the values a
# configuration file has to state
PORT_FIXED = {"rms_norm_eps": 1e-6, "tie_word_embeddings": True,
              "hidden_act": "silu", "z_loss": 1e-4,
              "qk_norm_scope": "head", "norm_topk_prob": True,
              "router_z_loss_coef": "router_aux_loss_coef"}


def _fixed_ok(config: dict) -> list:
    bad = []
    for key, want in PORT_FIXED.items():
        if key not in config:
            continue
        if key == "router_z_loss_coef":
            ok = config[key] == config.get(want)
        else:
            ok = config[key] == want
        if not ok:
            bad.append(key)
    return bad


def port_config(config: dict):
    """The program's ``ArchConfig`` of a configuration file."""
    from repro_torch import configs
    bad = _fixed_ok(config)
    if bad:
        raise SystemExit(f"bench: the program cannot run {config['arch']} "
                         f"with {bad} as the file states them")
    base = configs.get(config["arch"])
    kw = {FIELDS[k]: v for k, v in config.items() if k in FIELDS}
    kw["qk_norm"] = bool(config.get("qk_norm", False))
    kw["act_dtype_name"] = config["activation_dtype"]
    if config.get("num_experts"):
        kw["d_expert"] = kw["d_ff"] = config["intermediate_size"]
        kw["n_shared"] = 0
    else:
        kw["d_ff"] = config["intermediate_size"]
    if "tp_divisor" in config:
        kw["tp_divisor"] = config["tp_divisor"]
    return dataclasses.replace(base, **kw)


def param_shapes(config: dict) -> list:
    """``[(path, shape)]`` of the program's parameter tree for the
    configuration, read from its structure on the ``meta`` device."""
    import torch
    from repro_torch.models.api import build

    from weights import shapes_of
    cfg = port_config(config)
    like = build(cfg).init(torch.Generator(), torch.device("meta"))
    return shapes_of(like)
