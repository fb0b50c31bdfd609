"""Token-choice top-k Mixture-of-Experts LM (port of ``repro.models.moe``):
mixtral-8x7b, olmoe-1b-7b.

Dispatch is sort-based with a capacity factor, as the reference's,
within ``groups`` dispatch groups (one, unless a training caller asks
for more: the serving functions run one).  The attention, the norms
and the layer loop are the dense transformer's (``repro_torch.models.
transformer``); each block's MLP is the expert layer ``moe_mlp_fwd``.
Parameters are ``{"embedding", "layers": [{"attn", "moe": {"router",
"w_gate", "w_up", "w_down"}, "norm1", "norm2"}, ...], "final_norm"}``.

``moe_mlp_fwd`` reproduces the reference's numbers, bit for bit in
bf16: the fp32 router, ``lax.top_k``'s order (a tie goes to the lower
expert index: a stable descending sort), Python's half-to-even ``round``
for the capacity, a stable argsort for the dispatch, and the combine's
order.  XLA's scatter-add adds a token's k updates one at a time in the
order of the sorted dispatch list (ascending expert), rounding to the
compute dtype after each add; the combine here folds them in that order
with k gathers and adds, so it needs no atomics and gives the same bits
from run to run on the card.  The dispatch's backward (``_Dispatch``)
sums a token's k slot gradients the same way, in a fixed order, where
autograd of a gather would scatter-add them with atomics on the card.
The layer never synchronises with the host: the capacity is a Python
int computed from shapes.

``loss_fn`` is the reference's: cross entropy plus ``router_aux_coef``
times the mean load-balancing loss, with remat per layer.

Under capacity drops a token's output depends on the other tokens of its
group and on the group's size, which sets the capacity: on the serving
engine's decode bucket and the idle rows that pad it, and on a prefill's
padded tail (ROADMAP C-ref5).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

_ROUTING = contextvars.ContextVar("repro_torch_moe_routing", default=None)


@contextlib.contextmanager
def record_routing() -> Iterator[List[Dict[str, torch.Tensor]]]:
    """Collect each ``moe_mlp_fwd`` call's routing, in call order, into
    the list this yields: ``expert_idx`` (G, Tg, k), ``keep`` (G, Tg*k)
    in dispatch order and ``gap`` (G, Tg), each token's router
    probability of its k-th expert less that of its (k+1)-th (a
    decision a rounding can flip when the gap is tiny)."""
    calls: List[Dict[str, torch.Tensor]] = []
    token = _ROUTING.set(calls)
    try:
        yield calls
    finally:
        _ROUTING.reset(token)


def init_moe_mlp(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    E, d, f = cfg.n_experts, cfg.d_model, (cfg.expert_d_ff or cfg.d_ff)

    def draw(shape, scale):
        return (scale * torch.randn(shape, generator=gen, device=device)
                ).to(dtype)

    return {
        "router": L.normal_init(gen, (d, E), torch.float32, device,
                                scale=0.02),
        "w_gate": draw((E, d, f), 1.0 / math.sqrt(d)),
        "w_up": draw((E, d, f), 1.0 / math.sqrt(d)),
        "w_down": draw((E, f, d), 1.0 / math.sqrt(f)),
    }


class _Dispatch(torch.autograd.Function):
    """The dispatch gather ``buf[g, s] = x[g, slot_token[g, s]]`` (an
    empty slot reads a zero row past the tokens) with a backward that
    needs no atomics: ``dest`` (G, Tg*k) is each dispatch entry's slot,
    the sentinel ``E*C`` for a dropped one, and ``at`` (G, Tg, k) a
    token's k entries in dispatch order.  A token's gradient is the sum
    of its slots' gradients folded j = 0..k-1 in the compute dtype (the
    order of XLA's scatter-add, ascending slot).  The sentinel reads a
    zero row, so a dropped entry adds nothing, and no gradient reaches
    the zero row.  The slot index is built in the backward, so a forward
    without gradients pays nothing for it."""

    @staticmethod
    def forward(ctx, xt, slot_token, dest, at):
        G, Tg, d = xt.shape
        xg_pad = torch.cat([xt, xt.new_zeros(G, 1, d)], dim=1)
        ctx.save_for_backward(dest, at)
        return torch.gather(xg_pad, 1, slot_token[..., None].expand(
            G, slot_token.shape[1], d))

    @staticmethod
    def backward(ctx, dbuf):
        dest, at = ctx.saved_tensors
        G, Tg, k = at.shape
        d = dbuf.shape[-1]
        src = dest.gather(-1, at.reshape(G, Tg * k)).reshape(G, Tg, k)
        dpad = torch.cat([dbuf, dbuf.new_zeros(G, 1, d)], dim=1)
        dx = torch.zeros((G, Tg, d), dtype=dbuf.dtype, device=dbuf.device)
        for j in range(k):
            dx = dx + torch.gather(dpad, 1,
                                   src[:, :, j, None].expand(G, Tg, d))
        return dx, None, None, None


def moe_mlp_fwd(params, x: torch.Tensor, cfg: ModelConfig, *,
                groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out in x's dtype, fp32 load-balancing aux loss).

    Router in fp32; top-k gates renormalised (mixtral convention)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n_tok = B * S
    G = groups if n_tok % groups == 0 else 1
    Tg = n_tok // G
    dev = x.device
    xt = x.reshape(G, Tg, d)

    probs = torch.softmax(xt.float() @ params["router"].float(), dim=-1)
    ranked, by_prob = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = ranked[..., :k], by_prob[..., :k]   # (G,Tg,k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    # load-balancing auxiliary loss (Switch/Mixtral style)
    me = probs.mean(dim=1)                                        # (G,E)
    one_hot = expert_idx[..., None] == torch.arange(E, device=dev)
    ce = one_hot.float().sum(dim=2).mean(dim=1)                   # (G,E)
    aux = E * (me * ce).sum(dim=-1).mean()

    capacity = int(max(1, round(Tg * k / E * cfg.capacity_factor)))
    slots = E * capacity

    # dispatch: the (G, Tg*k) token-expert entries sorted by expert
    # (stable, so within an expert in token order); an entry past its
    # expert's capacity is dropped to the sentinel slot E*C
    flat_e = expert_idx.reshape(G, Tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(-1, order)
    token_of = order // k
    # exclusive starts of each expert's run (the reference's bincount
    # and cumsum; searchsorted needs no host sync for an output size)
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, device=dev).expand(G, E).contiguous())
    pos = torch.arange(Tg * k, device=dev) - starts.gather(-1, sorted_e)
    keep = pos < capacity
    dest = torch.where(keep, sorted_e * capacity + pos,
                       torch.full_like(pos, slots))
    # a token's k entries, as positions in the dispatch list, ascending
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(Tg * k, device=dev).expand(G, -1))
    at = rank.reshape(G, Tg, k).sort(dim=-1).values
    # gather-based dispatch: scatter the int slot -> token map (dropped
    # entries all land in the sentinel column, cut off), then gather the
    # rows of x padded with a zero row (empty slots read it)
    slot_token = torch.full((G, slots + 1), Tg, dtype=torch.long, device=dev)
    slot_token.scatter_(-1, dest, token_of)
    buf = _Dispatch.apply(xt, slot_token[:, :slots], dest,
                          at).reshape(G, E, capacity, d)

    # expert FFN (SwiGLU), batched over experts: (G,E,C,d) @ (E,d,f)
    gate = buf @ params["w_gate"]
    up = buf @ params["w_up"]
    out = (L.silu(gate) * up) @ params["w_down"]                  # (G,E,C,d)

    # combine in the compute dtype: each entry's expert output times its
    # gate (zero when dropped), a token's k updates folded one add at a
    # time in dispatch order, as XLA's scatter-add adds them.  Autograd
    # scatters each gather's gradient back without a collision that could
    # change a bit: kept entries read distinct slots, dropped ones (all
    # reading slot E*C-1) carry weight 0 and so an exactly zero gradient;
    # ``order`` and ``at`` are permutations of the entries
    flat = out.reshape(G, slots, d).to(x.dtype)
    gathered = torch.gather(flat, 1, dest.clamp(max=slots - 1)[..., None]
                            .expand(G, Tg * k, d))
    w = (gate_vals.reshape(G, Tg * k).gather(-1, order) * keep).to(x.dtype)
    upd = gathered * w[..., None]
    y = torch.zeros((G, Tg, d), dtype=x.dtype, device=dev)
    for j in range(k):
        y = y + torch.gather(upd, 1, at[:, :, j, None].expand(G, Tg, d))

    calls = _ROUTING.get()
    if calls is not None:
        gap = (ranked[..., k - 1] - ranked[..., k] if k < E
               else torch.full_like(ranked[..., 0], math.inf))
        calls.append({"expert_idx": expert_idx, "keep": keep,
                      "gap": gap.detach()})
    return y.reshape(B, S, d), aux.float()


# ---------------------------------------------------------------------------
# MoE transformer block / model (attention shared with the dense family)
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, dtype, device) -> Dict[str, Any]:
    return {
        "attn": L.init_attention(gen, T.attn_config(cfg), dtype, device),
        "moe": init_moe_mlp(gen, cfg, dtype, device),
        "norm1": L.init_norm(cfg.d_model, cfg.norm_type, dtype, device),
        "norm2": L.init_norm(cfg.d_model, cfg.norm_type, dtype, device),
    }


def _moe_residual(params, x, attn_out, cfg: ModelConfig, groups: int = 1):
    x = x + attn_out
    h2 = L.apply_norm(x, params["norm2"], cfg.norm_type)
    moe_out, aux = moe_mlp_fwd(params["moe"], h2, cfg, groups=groups)
    return x + moe_out, aux


def block_fwd(params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, kv_cache=None,
              cache_index: Optional[int] = None, groups: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux); the KV cache is written in place."""
    h = L.apply_norm(x, params["norm1"], cfg.norm_type)
    attn_out, _ = L.attention_fwd(params["attn"], h, T.attn_config(cfg),
                                  positions=positions, kv_cache=kv_cache,
                                  cache_index=cache_index)
    return _moe_residual(params, x, attn_out, cfg, groups)


def _remat_block(layer, x, cfg: ModelConfig, positions, groups: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``block_fwd`` recomputed in the backward pass (``T.remat``).  The
    recompute reruns the forward's kernels or plain versions on the same
    input, so it routes every token as the forward did; the forward
    alone records its routing (``record_routing``)."""
    calls, ran = _ROUTING.get(), []

    def body(h):
        token = _ROUTING.set(None if ran else calls)
        ran.append(True)
        try:
            return block_fwd(layer, h, cfg, positions=positions,
                             groups=groups)
        finally:
            _ROUTING.reset(token)

    return T.remat(body, x)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters with the reference's tree, shapes and scales
    (the router in fp32), drawn from ``generator`` on ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = T.dtype_of(cfg.param_dtype)
    return {
        "embedding": L.init_embedding(generator, cfg.padded_vocab,
                                      cfg.d_model, dtype, dev),
        "layers": [init_block(generator, cfg, dtype, dev)
                   for _ in range(cfg.n_layers)],
        "final_norm": L.init_norm(cfg.d_model, cfg.norm_type, dtype, dev),
    }


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_index: Optional[int] = None, remat: bool = False,
            groups: int = 1
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]],
                       torch.Tensor]:
    """Returns (hidden_states, cache, mean aux loss over the layers); the
    cache is filled in place.  ``remat`` (no cache) recomputes each layer
    in the backward pass; ``groups`` dispatch groups per expert layer."""
    x = T._embed_inputs(params, cfg, batch)
    S = x.shape[1]
    start = 0 if cache_index is None else cache_index
    positions = (start + torch.arange(S, device=x.device))[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params["layers"]):
        if remat and cache is None:
            x, a = _remat_block(layer, x, cfg, positions, groups)
        else:
            kv = None if cache is None else (cache["k"][i], cache["v"][i])
            x, a = block_fwd(layer, x, cfg, positions=positions,
                             kv_cache=kv, cache_index=cache_index,
                             groups=groups)
        aux = aux + a
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    return x, cache, aux / cfg.n_layers


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            remat: bool = True, groups: int = 1) -> torch.Tensor:
    """Mean next-token cross entropy plus ``router_aux_coef`` times the
    mean load-balancing loss, differentiable in the masters ``params``
    (cast to the compute dtype here, as ``transformer.loss_fn``)."""
    params = T.cast_params(params, cfg)
    hidden, _, aux = forward(params, cfg, batch, remat=remat, groups=groups)
    logits = T.logits_fn(params, cfg, hidden)
    ce = L.cross_entropy_loss(logits, batch["labels"], batch.get("mask"))
    return ce + cfg.router_aux_coef * aux


init_cache = T.init_cache


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    hidden, cache, _ = forward(params, cfg, batch, cache=cache,
                               cache_index=0)
    return T.logits_fn(params, cfg, hidden[:, -1:]), cache


def prefill_at(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
               cache: Dict[str, torch.Tensor], last_pos: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Bucketed prefill (``transformer.prefill_at``): logits at
    ``last_pos``.  Unlike the dense family's, the real positions are not
    blind to the padded tail: its tokens compete for expert capacity."""
    hidden, cache, _ = forward(params, cfg, batch, cache=cache,
                               cache_index=0)
    return T.logits_fn(params, cfg, hidden[:, last_pos:last_pos + 1]), cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_index: int
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    hidden, cache, _ = forward(params, cfg, {"tokens": tokens}, cache=cache,
                               cache_index=cache_index)
    return T.logits_fn(params, cfg, hidden), cache


def decode_paged(params, cfg: ModelConfig, tokens: torch.Tensor,
                 pools: Dict[str, torch.Tensor], page_table: torch.Tensor,
                 lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode over the shared paged KV pool
    (``transformer.decode_paged``), MoE blocks.  Every row, idle ones
    too, is routed and competes for capacity."""
    x = T._embed_inputs(params, cfg, {"tokens": tokens})
    positions = lengths.long()[:, None]
    acfg = T.attn_config(cfg)
    for i, layer in enumerate(params["layers"]):
        h = L.apply_norm(x, layer["norm1"], cfg.norm_type)
        attn_out = L.attention_fwd_paged(
            layer["attn"], h, acfg, positions=positions,
            k_pages=pools["k"][i], v_pages=pools["v"][i],
            page_table=page_table, lengths=lengths)
        x, _ = _moe_residual(layer, x, attn_out, cfg)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    return T.logits_fn(params, cfg, x), pools
