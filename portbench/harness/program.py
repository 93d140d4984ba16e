"""The system under test, ``druglamp_tpu_torch``, as the benchmark drives it:
its model built at the configuration's sizes on the device, with the
benchmark's weights, its train state, and its device-resident drivers.
Nothing else of the program is used."""

from __future__ import annotations

import torch


def build_model(cfg: dict, device):
    """The configuration's model class at its sizes, on ``device``, in
    train mode, its parameters unset (``weights.load_into`` sets them) and
    its BatchNorm statistics at 0 and 1.  Built on the host (its
    initializers' values are thrown away) and placed with ``to_empty``."""
    from druglamp_tpu_torch.config import (Config, DecoderConfig, DrugConfig, ProteinConfig,
                                           SolverConfig)
    from druglamp_tpu_torch.models.registry import COMPUTE_DTYPES, get_model_class

    dec = cfg["decoder"]
    pc = Config(drug=DrugConfig(node_in_feats=cfg["node_in_feats"], max_nodes=cfg["max_nodes"]),
                protein=ProteinConfig(kernel_size=tuple(cfg["kernel_size"]),
                                      seq_len=cfg["seq_len"], site_len=cfg["site_len"],
                                      max_resis=cfg["max_resis"]),
                decoder=DecoderConfig(in_dim=dec["in_dim"], hidden_dim=dec["hidden_dim"],
                                      out_dim=dec["out_dim"], binary=dec["binary"]),
                solver=SolverConfig(compute_dtype=cfg["compute_dtype"],
                                    grad_mode=cfg["grad_mode"]),
                n_hidden=cfg["n_hidden"], pmma_dropout=cfg["pmma_dropout"])
    model = get_model_class(cfg["model"])(
        n_drug_feature=cfg["drug_llm_dim"], n_prot_feature=cfg["prot_llm_dim"], config=pc,
        compute_dtype=COMPUTE_DTYPES[cfg["compute_dtype"]])
    model.to_empty(device=device)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if not name.endswith(("running_mean", "running_var")):
                raise ValueError(f"a buffer the benchmark does not set: {name}")
            buf.fill_(1.0 if name.endswith("running_var") else 0.0)
    return model


def train_state(model, gates: dict):
    from druglamp_tpu_torch.train.state import TrainState

    return TrainState.create(model, gates["ssl"], gates["cm"], flat_opt=False)


def epoch_driver(model, cfg: dict, gates: dict, device):
    """The epoch driver over the device-resident library."""
    from druglamp_tpu_torch.train.steps import make_epoch_step_gather

    return make_epoch_step_gather(model, gates["ssl"], gates["cm"], include_llm=True,
                                  emb_ordinals=True, calibrate=gates["calibrate"],
                                  grad_mode=cfg["grad_mode"], device=device)


def eval_driver(model, device):
    from druglamp_tpu_torch.train.steps import make_eval_scan_gather

    return make_eval_scan_gather(model, include_llm=True, emb_ordinals=True, device=device)


def first_moments(state) -> dict:
    """Each optimizer's first moment per parameter after its first step, over
    (1 − β1): the gradient it was given (zero where it holds no moment)."""
    out = {}
    for name in ("cls", "ssl", "cm"):
        opt = getattr(state, "opt_" + name)
        if opt is None:
            continue
        group = opt.param_groups[0]
        b1 = group["betas"][0]
        out[name] = [opt.state[p]["exp_avg"] / (1.0 - b1) if "exp_avg" in opt.state[p]
                     else torch.zeros_like(p) for p in group["params"]]
    return out
