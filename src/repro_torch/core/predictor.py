"""ECCOS-T: training-based multi-objective predictor (paper §3.1, Fig. 2).

The port of ``repro.core.predictor``'s forward pass.  A small BERT-style
encoder produces the query embedding q; each pool model has a learned
embedding e_j; two heads read the interaction vector q ⊙ e_j:

    capability  s_ij = sigmoid( W1 (q ⊙ e_j) + b1 )           (Eq. 3)
    length      P(B_k | i,j) = softmax( W2 (q ⊙ e_j) + b2 )_k (Eq. 4)

Parameters keep the JAX layout (``wqkv`` is (d, 3, h, hd), ``wo`` is
(h, hd, d)), so weights carry across unchanged (``repro_torch.convert``).
``PredictorNet`` holds them as an ``nn.Module``; the functions below take
the plain dict tree.  ``TrainedPredictor.fit`` trains the heads with BCE
(capability) + CE (length buckets) under AdamW (``repro_torch.training``),
with the reference's batch order; the backward pass is autograd over the
same einsums.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common import ParamDecl, default_device, init_params
from repro_torch.configs.base import TrainConfig
from repro_torch.data import tokenizer
from repro_torch.data.qaserve import L_MAX, bucketize
from repro_torch.training.optim import AdamW, tree_leaves, tree_map

from .features import predicted_cost


@dataclasses.dataclass(frozen=True)
class PredictorConfig:
    """Sized for the routing latency budget (the reference's defaults)."""

    n_models: int = 6
    vocab: int = tokenizer.VOCAB
    max_len: int = 48
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    n_buckets: int = 10          # paper default (Table 3)
    lr: float = 1e-3


def _enc_layer_decls(cfg: PredictorConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.d_model // cfg.n_heads
    f32 = torch.float32
    return {
        "ln1": ParamDecl((d,), ("p_none",), init="ones", dtype=f32),
        "wqkv": ParamDecl((d, 3, h, hd),
                          ("p_embed", "p_none", "p_heads", "p_none"),
                          init="scaled", dtype=f32),
        "wo": ParamDecl((h, hd, d), ("p_heads", "p_none", "p_embed"),
                        init="scaled", dtype=f32),
        "ln2": ParamDecl((d,), ("p_none",), init="ones", dtype=f32),
        "w1": ParamDecl((d, cfg.d_ff), ("p_embed", "p_mlp"), init="scaled",
                        dtype=f32),
        "w2": ParamDecl((cfg.d_ff, d), ("p_mlp", "p_embed"), init="scaled",
                        dtype=f32),
    }


def predictor_decls(cfg: PredictorConfig) -> dict:
    """The reference's tree, its logical axes and its float32 dtype."""
    d, f32 = cfg.d_model, torch.float32
    return {
        "tok_embed": ParamDecl((cfg.vocab, d), ("p_vocab", "p_embed"),
                               init="normal", dtype=f32),
        "pos_embed": ParamDecl((cfg.max_len, d), ("p_none", "p_embed"),
                               init="normal", dtype=f32),
        "layers": [_enc_layer_decls(cfg) for _ in range(cfg.n_layers)],
        "final_ln": ParamDecl((d,), ("p_none",), init="ones", dtype=f32),
        "model_embed": ParamDecl((cfg.n_models, d), ("p_none", "p_embed"),
                                 init="normal", scale=0.5, dtype=f32),
        "cap_w": ParamDecl((d,), ("p_embed",), init="scaled", dtype=f32),
        "cap_b": ParamDecl((), (), init="zeros", dtype=f32),
        "len_w": ParamDecl((d, cfg.n_buckets), ("p_embed", "p_none"),
                           init="scaled", dtype=f32),
        "len_b": ParamDecl((cfg.n_buckets,), ("p_none",), init="zeros",
                           dtype=f32),
    }


def _ln(x, w, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w


def encode_queries(cfg: PredictorConfig, params: dict, tokens):
    """tokens: (B, T) int -> pooled embedding (B, d)."""
    _, t = tokens.shape
    tokens = tokens.long()
    mask = tokens != tokenizer.PAD
    x = params["tok_embed"][tokens] + params["pos_embed"][None, :t]
    hd = cfg.d_model // cfg.n_heads
    for lp in params["layers"]:
        y = _ln(x, lp["ln1"])
        qkv = torch.einsum("btd,dghe->btghe", y, lp["wqkv"])
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        s = torch.einsum("bthe,bshe->bhts", q, k) / np.sqrt(hd)
        s = torch.where(mask[:, None, None, :], s, -1e30)
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhts,bshe->bthe", a, v)
        x = x + torch.einsum("bthe,hed->btd", o, lp["wo"])
        y = _ln(x, lp["ln2"])
        # jax.nn.gelu defaults to the tanh approximation
        x = x + F.gelu(y @ lp["w1"], approximate="tanh") @ lp["w2"]
    x = _ln(x, params["final_ln"])
    maskf = mask.to(x.dtype)
    denom = torch.clamp(maskf.sum(-1, keepdim=True), min=1.0)
    return (x * maskf[..., None]).sum(1) / denom  # mean-pool (B, d)


def predict(cfg: PredictorConfig, params: dict, tokens):
    """Returns (capability (B, M), length_probs (B, M, K))."""
    q = encode_queries(cfg, params, tokens)              # (B, d)
    inter = q[:, None, :] * params["model_embed"][None]  # (B, M, d)
    cap = torch.sigmoid(inter @ params["cap_w"] + params["cap_b"])
    len_logits = inter @ params["len_w"] + params["len_b"]
    return cap, torch.softmax(len_logits, dim=-1)


def trained_predict_device(cfg: PredictorConfig, params: dict, tokens,
                           input_len, price_in, price_out):
    """ECCOS-T predict on tensors: tokens -> (cap, exp_len, cost); the
    length-bucket expectation (midpoint rule) and the cost matrix stay on
    the device."""
    cap, len_probs = predict(cfg, params, tokens[:, :cfg.max_len])
    width = L_MAX / cfg.n_buckets
    mids = (torch.arange(cfg.n_buckets, dtype=torch.float32,
                         device=cap.device) + 0.5) * width
    exp_len = len_probs @ mids                           # (B, M)
    return cap, exp_len, predicted_cost(input_len, exp_len, price_in,
                                        price_out)


def loss_fn(cfg: PredictorConfig, params: dict, batch: Dict):
    """BCE over the capability logits + CE over the length buckets, in the
    reference's forms; returns (loss, {"bce", "ce"})."""
    q = encode_queries(cfg, params, batch["tokens"])
    inter = q[:, None, :] * params["model_embed"][None]
    cap_logit = inter @ params["cap_w"] + params["cap_b"]      # (B, M)
    len_logits = inter @ params["len_w"] + params["len_b"]     # (B, M, K)
    y = batch["correct"].to(torch.float32)
    bce = torch.mean(torch.clamp(cap_logit, min=0) - cap_logit * y
                     + torch.log1p(torch.exp(-cap_logit.abs())))
    lb = batch["len_bucket"].long()
    ce = -torch.mean(torch.gather(torch.log_softmax(len_logits, -1), -1,
                                  lb[..., None]))
    return bce + ce, {"bce": bce, "ce": ce}


def prediction_accuracy(ds, cap, exp_len, n_buckets: int
                        ) -> Dict[str, float]:
    """Capability accuracy and length-bucket hit rates of NumPy predictions
    against a labelled dataset — the schema every predictor reports."""
    cap_acc = float(((cap > 0.5) == (ds.correct > 0)).mean())
    pred_b = bucketize(exp_len, n_buckets)
    true_b = bucketize(ds.out_len, n_buckets)
    return {"capability_acc": cap_acc,
            "bucket_exact": float((pred_b == true_b).mean()),
            "bucket_within1": float((np.abs(pred_b - true_b) <= 1).mean())}


class PredictorNet(nn.Module):
    """The encoder and its two heads as an ``nn.Module`` over a parameter
    tree in the JAX layout; ``forward`` is :func:`predict`."""

    def __init__(self, cfg: PredictorConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.top = nn.ParameterDict({
            k: nn.Parameter(v, requires_grad=False)
            for k, v in params.items() if k != "layers"})
        self.layers = nn.ModuleList([
            nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                              for k, v in lp.items()})
            for lp in params["layers"]])

    def tree(self) -> dict:
        """The parameters as the dict tree the functions take."""
        out = dict(self.top.items())
        out["layers"] = [dict(lp.items()) for lp in self.layers]
        return out

    def forward(self, tokens):
        return predict(self.cfg, self.tree(), tokens)


class TrainedPredictor:
    """ECCOS-T over given parameters, or ones initialised from ``seed``;
    :meth:`fit` trains them."""

    def __init__(self, cfg: PredictorConfig, params: Optional[dict] = None,
                 *, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = default_device(device)
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            params = init_params(predictor_decls(cfg), gen, self.device)
        self.net = PredictorNet(cfg, params).to(self.device)

    @property
    def params(self) -> dict:
        return self.net.tree()

    def fit(self, ds, *, steps: int = 300, batch: int = 64, seed: int = 0,
            log_every: int = 0, init: Optional[dict] = None):
        """Train on a labelled dataset with AdamW (lr ``cfg.lr``, weight
        decay 0.01, fp32 moments, clip 1.0); returns the per-step losses.

        The batches are the reference's: ``np.random.RandomState(seed)``
        draws each one without replacement.  The parameters start from
        ``init`` (a tree, e.g. the JAX package's initial parameters) or
        from ``torch.Generator().manual_seed(seed)``.  The data moves to
        the device once and the losses are read once, at the end."""
        cfg, dev = self.cfg, self.device
        if init is None:
            init = init_params(predictor_decls(cfg),
                               torch.Generator().manual_seed(seed), dev)
        params = tree_map(lambda t: t.detach().to(dev, torch.float32)
                          .clone().requires_grad_(True), init)
        # one flat list in the reference's leaf order (dict keys sorted):
        # AdamW's global norm sums the leaves in that order
        flat = tree_leaves(params)
        opt = AdamW(TrainConfig(learning_rate=cfg.lr, weight_decay=0.01,
                                moment_dtype="fp32", grad_clip=1.0))
        state = opt.init(flat)
        toks = torch.as_tensor(
            tokenizer.encode_batch(ds.queries, cfg.max_len), device=dev)
        correct = torch.as_tensor(np.asarray(ds.correct), device=dev)
        buckets = torch.as_tensor(bucketize(ds.out_len, cfg.n_buckets),
                                  device=dev)
        rng = np.random.RandomState(seed)
        order = torch.as_tensor(np.array(
            [rng.choice(ds.n, size=min(batch, ds.n), replace=False)
             for _ in range(steps)], np.int64), device=dev)
        losses = []
        for it in range(steps):
            idx = order[it]
            loss, _ = loss_fn(cfg, params, {"tokens": toks[idx],
                                            "correct": correct[idx],
                                            "len_bucket": buckets[idx]})
            opt.update(list(torch.autograd.grad(loss, flat)), state, flat)
            losses.append(loss.detach())
            if log_every and it % log_every == 0:
                print(f"predictor step {it}: loss {float(loss):.4f}")
        self.net = PredictorNet(cfg, tree_map(torch.Tensor.detach, params))
        return torch.stack(losses).tolist() if losses else []

    # --- the device predict contract (shared with Retrieval/Hybrid) -------
    @property
    def token_len(self) -> int:
        return self.cfg.max_len

    def device_inputs(self):
        return (self.params,)

    def predict_device(self, inputs, tokens, input_len, price_in, price_out):
        return trained_predict_device(self.cfg, inputs[0], tokens, input_len,
                                      price_in, price_out)

    def predict_arrays(self, ds):
        """Returns (capability (N,M), expected_out_len (N,M), cost (N,M)) as
        NumPy for anything exposing the RouteBatch feature surface."""
        dev = self.device
        toks = torch.as_tensor(
            tokenizer.encode_batch(ds.queries, self.cfg.max_len), device=dev)
        with torch.no_grad():
            out = self.predict_device(
                self.device_inputs(), toks,
                torch.as_tensor(ds.input_len, dtype=torch.float32, device=dev),
                torch.as_tensor(ds.price_in, dtype=torch.float32, device=dev),
                torch.as_tensor(ds.price_out, dtype=torch.float32,
                                device=dev))
        return tuple(t.cpu().numpy() for t in out)

    def eval_accuracy(self, ds) -> Dict[str, float]:
        cap, exp_len, _ = self.predict_arrays(ds)
        return prediction_accuracy(ds, cap, exp_len, self.cfg.n_buckets)
