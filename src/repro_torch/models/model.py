"""Model assembly: init / forward for every family of the reference: the
dense decoder, the audio, MoE, vlm, hybrid and ssm families (counterpart
of ``repro/models/model.py``).

Parameters keep the reference's tree: ``{"stages": ({"b0": block}, ...),
"final_norm", "lm_head", "embed"}`` with each block's leaves stacked over the
stage's layers on a leading axis; a model whose ``input_kind`` is
``"embeddings"`` (the audio family's) has no ``embed``: :func:`forward`
takes its ``(B, S, d_model)`` frame embeddings. The reference's ``lax.scan`` over layers
becomes a Python loop that takes layer ``l``'s views of the stacked leaves
(``unbind`` views where a leaf takes gradients: :func:`unbound_layers`).

One :func:`forward` serves train, prefill and decode:
  train    cache=None                      → logits (B, S, V); with
           ``with_aux=True`` also the MoE load-balance loss, ``remat=True``
           a ``torch.utils.checkpoint`` a layer (``train/step.py``)
  prefill  cache=init_cache(...), pos=0    → logits (B, 1, V) with "last"
  chunk    cache rows [0, pos) filled, pos > 0, S > 1 → the next S prompt
           tokens (a chunked prefill, or the suffix after a cached prefix):
           logits (B, 1, V) with "last", the bits of the whole prompt's
           prefill on the GPU (``layers.attention``)
  decode   cache=filled, pos=cur_len       → logits (B, 1, V)
  verify   cache=filled, pos, chunked_decode=True → logits (B, S, V)
The cache is updated in place (``layers._cache_write``, and the recurrent
state by the blocks of ``models/recurrent.py``) and returned.
``collect_states=True`` (a speculative verify) leaves the recurrent leaves
as they were and returns, in their place, their per-token stacks
``(repeat, S, B, ...)``, the reference's layout; the positional leaves are
the live cache's, written. ``collect_states`` may also name step indices (a
prefill whose recurrent boundary states the prefix cache commits): the
stacks then hold the states after those steps only, ``(repeat, S', B,
...)``, since an mLSTM layer's state is a (Dh × Dh) matrix a head.

Block types: ``attn`` (dense), ``cross`` (the vlm family's: the leaves of
``attn``, its queries attending the image memory, ``layers.attention``'s
cross path; its cache ``k_img`` / ``v_img`` ``(repeat, B, n_image_tokens,
Hkv, Dh)`` in the cache dtype, an int8 cache's too, written by a forward
given ``image_emb`` and read by one without it), ``attn_moe`` (attention, then a bank of
experts in place of the MLP, ``models/moe.py``; its cache is an ``attn``
cache), ``local_attn`` (attention over a window on a
ring cache of ``min(s_max, window)`` rows), ``rglru`` (Griffin's recurrent
block, whose state is ``h`` (B, W) f32 and ``conv`` (B, K-1, W)), and the
xLSTM cells ``mlstm`` (state ``c`` (B, NH, Dh, Dh), ``n``, ``m``) and
``slstm`` (``h``, ``c``, ``n``, ``m``, each (B, NH, Dh)), which hold no MLP:
the block is ``h + cell(rmsnorm(h))``. Their state starts at ``m = -inf``
(and the sLSTM's ``n = 1e-6``), not at zeros: :func:`reset_cache` puts any
cache back to :func:`init_cache`'s values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.kernels.ops import linear
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.ctx import all_gather_cols
from repro_torch.utils import host_pos, prompt_rows, resolve_device, tree_leaves, tree_map, tree_map_with_path

ATTN_BLOCKS = ("attn", "attn_moe", "local_attn", "cross")
XLSTM_BLOCKS = ("mlstm", "slstm")
RECURRENT_BLOCKS = ("rglru",) + XLSTM_BLOCKS
BLOCKS = ATTN_BLOCKS + RECURRENT_BLOCKS
_CELLS = {"rglru": R.rglru_block, "mlstm": R.mlstm_block, "slstm": R.slstm_block}


def _check_block(btype: str) -> None:
    if btype not in BLOCKS:
        raise ValueError(f"unknown block type {btype!r}; known: {BLOCKS}")


def init_block(gen: torch.Generator, cfg: ModelConfig, btype: str, repeat: int, device) -> dict:
    _check_block(btype)
    d, lead = cfg.d_model, (repeat,)
    p = {"ln1": torch.ones((*lead, d), dtype=cfg.pdtype, device=device)}
    if btype in XLSTM_BLOCKS:  # the cell carries its own projections: no MLP
        p["mix"] = (R.init_mlstm if btype == "mlstm" else R.init_slstm)(gen, cfg, lead, device)
        return p
    if btype == "rglru":
        p["mix"] = R.init_rglru(gen, cfg, lead, device)
    else:
        p["attn"] = L.init_attention(gen, cfg, lead, device)
    p["ln2"] = torch.ones((*lead, d), dtype=cfg.pdtype, device=device)
    p["mlp"] = (M.init_moe if btype == "attn_moe" else L.init_mlp)(gen, cfg, lead, device)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (same shapes, dtypes and scales as the reference's ``init_params``; the
    values differ, since the generators differ). On ``device="meta"`` the
    leaves hold shapes and dtypes only, the dry run's structs
    (``launch/dryrun.py``): no generator is drawn, since torch has none for
    the meta device."""
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    stages = tuple(
        {f"b{bi}": init_block(gen, cfg, bt, repeat, dev) for bi, bt in enumerate(pattern)}
        for pattern, repeat in cfg.stages
    )
    lm_head = L._dense_init(gen, (cfg.d_model, cfg.vocab), cfg.d_model, cfg.pdtype, dev)
    params = {
        "stages": stages,
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.pdtype, device=dev),
        "lm_head": lm_head,
    }
    if cfg.input_kind == "tokens":  # an embeddings-input model has no table
        embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=dev) * 0.02
        params["embed"] = embed.to(cfg.pdtype)
    return params


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=None, *, device="cuda",
               ring: Optional[int] = None) -> dict:
    """Zeroed decoding state, stacked per stage like the params:
    ``k``/``v`` of shape ``(repeat, B, s_max, Hkv, Dh)`` in ``dtype``
    (default the compute dtype). With ``cfg.kv_cache_dtype == "int8"``
    ``k``/``v`` are int8 codes and ``k_scale``/``v_scale`` their f32 scales,
    ``(repeat, B, s_max, Hkv)``: one per (token, head), as the reference's
    int8 cache holds them. A ``local_attn`` block's rows are a ring of
    ``min(s_max, window)`` (or ``ring``, when given: a batch-1 admission
    cache takes its slot cache's ring length, since a ring's slot layout
    depends on its length); an ``rglru`` block holds ``h`` ``(repeat, B,
    W)`` f32 and ``conv`` ``(repeat, B, K-1, W)`` in ``dtype``; an xLSTM
    block its f32 state at the reference's initial values
    (``recurrent.init_state``); a ``cross`` block its image memory
    ``k_img`` / ``v_img`` ``(repeat, B, n_image_tokens, Hkv, Dh)`` in
    ``dtype`` whatever ``kv_cache_dtype`` says, as the reference keeps it."""
    dev = resolve_device(device)
    dtype = dtype or cfg.cdtype

    def block_cache(btype, repeat):
        _check_block(btype)
        if btype in XLSTM_BLOCKS:
            return R.init_state(cfg, btype, batch, (repeat,), dev)
        if btype == "cross":
            shape = (repeat, batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.d_head)
            return {"k_img": torch.zeros(shape, dtype=dtype, device=dev),
                    "v_img": torch.zeros(shape, dtype=dtype, device=dev)}
        if btype == "rglru":
            w = cfg.lru_width
            return {
                "h": torch.zeros((repeat, batch, w), dtype=torch.float32, device=dev),
                "conv": torch.zeros((repeat, batch, cfg.conv_width - 1, w), dtype=dtype, device=dev),
            }
        rows = s_max
        if btype == "local_attn":
            rows = ring if ring is not None else min(s_max, cfg.window)
        shape = (batch, rows, cfg.n_kv_heads, cfg.d_head)
        if cfg.kv_cache_dtype == "int8":
            return {
                "k": torch.zeros((repeat, *shape), dtype=torch.int8, device=dev),
                "v": torch.zeros((repeat, *shape), dtype=torch.int8, device=dev),
                "k_scale": torch.zeros((repeat, *shape[:-1]), dtype=torch.float32, device=dev),
                "v_scale": torch.zeros((repeat, *shape[:-1]), dtype=torch.float32, device=dev),
            }
        return {
            "k": torch.zeros((repeat, *shape), dtype=dtype, device=dev),
            "v": torch.zeros((repeat, *shape), dtype=dtype, device=dev),
        }

    return {
        "stages": tuple(
            {f"b{bi}": block_cache(bt, repeat) for bi, bt in enumerate(pattern)}
            for pattern, repeat in cfg.stages
        )
    }


def reset_cache(cfg: ModelConfig, cache: dict) -> dict:
    """Put every leaf of ``cache`` (a whole cache, or a tree of views of its
    rows, e.g. one slot's) back to :func:`init_cache`'s values, in place:
    zeros, and the xLSTM cells' initial ``m`` and ``n``
    (``recurrent.INITIAL_VALUES``). A cross block's static image memory is
    zeroed too: the next prefill given image embeddings writes it, and one
    without them attends zeros, as a fresh cache's. Returns ``cache``."""
    for (pattern, _), stage in zip(cfg.stages, cache["stages"]):
        for bi, btype in enumerate(pattern):
            for name, leaf in stage[f"b{bi}"].items():
                leaf.fill_(R.initial_value(btype, name))
    return cache


def layer_slice(tree, l: int):
    """Layer ``l``'s views of a stacked block tree (no copies)."""

    def take(leaf):
        if isinstance(leaf, QuantizedTensor):
            return leaf.replace(packed=leaf.packed[l], scales=leaf.scales[l])
        return leaf[l]

    return tree_map(take, tree)


def apply_block(
    p: dict,
    cfg: ModelConfig,
    btype: str,
    h: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[dict],
    pos,
    image_emb: Optional[torch.Tensor] = None,
    *,
    chunked: bool = False,
    collect: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """One pre-norm decoder block → (h, cache). ``chunked``: the block's
    tokens are a chunked decode (``layers.attention``), and the MLP sees
    them as token rows. ``collect`` (True, or step indices): a recurrent
    block returns its state stacks instead of the cache
    (``models/recurrent.py``). An xLSTM block has no MLP. An ``attn_moe``
    block's experts see all of the call's tokens at once (capacity couples
    them); :func:`forward` ``(with_aux=True)`` also collects its
    load-balance loss. A ``cross`` block attends the image memory of
    :func:`image_memory`."""
    h, cache, _ = _block(p, cfg, btype, h, positions, cache, pos, image_emb, chunked=chunked, collect=collect)
    return h, cache


def _block(p, cfg, btype, h, positions, cache, pos, image_emb=None, *, chunked=False, collect=False, aux=False):
    """:func:`apply_block`, returning also the block's MoE load-balance loss
    (an ``attn_moe`` block's, when ``aux``; else None)."""
    _check_block(btype)
    if btype in RECURRENT_BLOCKS:
        r, cache = _CELLS[btype](p["mix"], cfg, L.rmsnorm(p["ln1"], h), cache, collect=collect, chunked=chunked)
        if btype in XLSTM_BLOCKS:
            return h + r, cache, None
    elif btype == "cross":
        r, cache = L.attention(p["attn"], cfg, L.rmsnorm(p["ln1"], h), positions, cache=cache, chunked=chunked,
                               kv_override=image_memory(p["attn"], cfg, cache, pos, image_emb))
    else:
        window = cfg.window if btype == "local_attn" else 0
        r, cache = L.attention(
            p["attn"], cfg, L.rmsnorm(p["ln1"], h), positions, cache=cache, pos=pos, window=window,
            chunked=chunked,
        )
    h = h + r
    x = L.rmsnorm(p["ln2"], h)
    if btype == "attn_moe":
        y, loss = M.moe_apply(p["mlp"], cfg, x, aux=aux)
        return h + y, cache, loss
    if chunked:
        return h + L.mlp_swiglu(p["mlp"], L.token_rows_view(x)).reshape(h.shape), cache, None
    return h + L.mlp_swiglu(p["mlp"], x), cache, None


def _takes_grad(tree) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tree_leaves(tree))


def unbound_layers(tree, repeat: int) -> list:
    """Each layer's views of a stacked block tree, by ``unbind``: the
    backward of ``unbind`` stacks the layers' gradients into the leaf's once,
    where one ``leaf[l]`` a layer would give the leaf ``repeat`` full-size
    gradients to add (zeros but for one layer each)."""
    parts = {}
    tree_map_with_path(lambda path, leaf: parts.__setitem__(path, leaf.unbind(0)), tree)
    return [tree_map_with_path(lambda path, _: parts[path][l], tree) for l in range(repeat)]


def image_memory(p: dict, cfg: ModelConfig, cache: Optional[dict], pos, image_emb: Optional[torch.Tensor]):
    """The ``(k_mem, v_mem)`` a cross block attends, ``(B, N, Hkv, Dh)``
    each: with ``image_emb`` ``(B, N, d_model)``, its projections by the
    block's ``wk`` / ``wv`` (no RoPE), written into the cache's ``k_img`` /
    ``v_img`` in place (cast to the cache's dtype) when there is one; without
    it, a decoding state's (``cache`` and ``pos``) stored memory: a decode
    step, a verify, or a prefill given no image embeddings, which attends a
    fresh cache's zeros as the reference's does. As in the reference,
    ``image_emb`` is not cast to the compute dtype first."""
    if image_emb is None:
        if cache is None or pos is None:
            raise ValueError("a cross-attention block needs image_emb, or a decoding state (cache and pos) "
                             "holding the image memory")
        return cache["k_img"], cache["v_img"]
    b, n, _ = image_emb.shape
    k = linear(image_emb, p["wk"]).reshape(b, n, cfg.n_kv_heads, cfg.d_head)
    v = linear(image_emb, p["wv"]).reshape(b, n, cfg.n_kv_heads, cfg.d_head)
    if cache is not None:
        cache["k_img"].copy_(k)
        cache["v_img"].copy_(v)
    return k, v


def forward(
    cfg: ModelConfig,
    params: dict,
    *,
    tokens: Optional[torch.Tensor] = None,
    embeddings: Optional[torch.Tensor] = None,
    image_emb: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    pos=None,
    logits_mode: str = "all",  # "all" | "last"
    chunked_decode: bool = False,
    prefill: bool = False,
    collect_states: bool = False,
    remat: bool = False,
    with_aux: bool = False,
):
    """Run the decoder on ``tokens (B, S)``, or on ``embeddings (B, S,
    d_model)`` for an embeddings-input model (cast to the compute dtype).
    Returns (logits f32, cache). ``image_emb (B, N, d_model)`` is a vlm
    model's image memory (:func:`image_memory`): given, every cross block
    projects it (and stores it in the cache); not given, the cross blocks
    attend the cache's.

    ``chunked_decode=True`` feeds S > 1 tokens mid-sequence against a
    filled cache at ``pos`` (a speculative verify): every position's logits
    are those S single-token decode steps would give, bit for bit.
    ``prefill=True`` says the tokens are prompt tokens (a whole prompt at
    pos 0, or a chunk or suffix at pos > 0), so a single token takes the
    prefill attention as S > 1 tokens always do, not a decode step's: a
    one-token last chunk then gets the bits it has in the whole prompt,
    in the attention and in the dense products: one
    :func:`~repro_torch.utils.prompt_rows` scope carries the flag to both.

    ``collect_states=True`` returns, in place of the cache, its tree with
    every recurrent leaf replaced by its per-token stack ``(repeat, S, B,
    ...)`` (entry t: the state after token t); the live cache's recurrent
    leaves keep their values, its positional ones are written. Step indices
    (ascending, distinct) in place of True keep only those steps' states:
    ``(repeat, S', B, ...)``, entry j the state after step
    ``collect_states[j]``.

    Training options (off by default, so the return value above holds):
    ``with_aux=True`` returns ``(logits, cache, aux)``, ``aux`` the f32 sum of
    every MoE layer's load-balance loss (0 for a model without experts), in
    the reference's order (its ``_apply_stage`` adds each block's in turn,
    a stage at a time); ``remat=True`` runs each period of a stage's pattern
    (one layer's blocks) under ``torch.utils.checkpoint`` (non-reentrant),
    the counterpart of the reference's ``jax.checkpoint`` of its scan body:
    a backward then holds one period's activations at a time and recomputes
    them. It takes no cache."""
    if remat and cache is not None:
        raise ValueError("remat is a training option: it takes no cache")
    if chunked_decode and cache is None:
        raise ValueError("chunked_decode needs a filled cache")
    if collect_states is not False and collect_states is not None and cache is None:
        raise ValueError("collect_states needs a decoding state")
    if (tokens is None) == (embeddings is None):
        raise ValueError("forward takes exactly one of tokens and embeddings")
    with prompt_rows(prefill):
        logits, cache, aux = _forward(cfg, params, tokens, embeddings, image_emb, positions, cache, pos,
                                      logits_mode, chunked_decode, collect_states, remat, with_aux)
    return (logits, cache, aux) if with_aux else (logits, cache)


def _forward(cfg, params, tokens, embeddings, image_emb, positions, cache, pos, logits_mode, chunked_decode,
             collect=False, remat=False, with_aux=False):
    if tokens is not None:
        h = params["embed"][tokens].to(cfg.cdtype)
    else:
        h = embeddings.to(cfg.cdtype)
    b, s = h.shape[:2]
    if positions is None:
        if pos is None:
            base = torch.zeros((b, 1), dtype=torch.int32, device=h.device)
        elif isinstance(pos, torch.Tensor) and pos.dim() == 1:
            base = pos.to(device=h.device, dtype=torch.int32)[:, None]
        else:
            base = torch.full((b, 1), host_pos(pos), dtype=torch.int32, device=h.device)
        positions = base + torch.arange(s, dtype=torch.int32, device=h.device)[None, :]

    stacks = {}  # (stage, block key) → per layer, the collected state stacks
    aux = torch.zeros((), dtype=torch.float32, device=h.device) if with_aux else None
    for si, (pattern, repeat) in enumerate(cfg.stages):
        stage_p = params["stages"][si]
        stage_c = None if cache is None else cache["stages"][si]
        split = ({key: unbound_layers(blk, repeat) for key, blk in stage_p.items()} if _takes_grad(stage_p)
                 else None)

        def period(h, stage_aux, l, pattern=pattern, stage_p=stage_p, stage_c=stage_c, split=split, si=si):
            for bi, btype in enumerate(pattern):
                key = f"b{bi}"
                c_in = None if stage_c is None else layer_slice(stage_c[key], l)
                coll = collect if btype in RECURRENT_BLOCKS else False
                p_l = layer_slice(stage_p[key], l) if split is None else split[key][l]
                h, c_out, loss = _block(p_l, cfg, btype, h, positions, c_in, pos, image_emb,
                                        chunked=chunked_decode, collect=coll, aux=with_aux)
                if loss is not None:
                    stage_aux = stage_aux + loss
                if coll is not False:
                    stacks.setdefault((si, key), []).append(c_out)
            return h, stage_aux

        stage_aux = torch.zeros_like(aux) if with_aux else None
        for l in range(repeat):
            if remat:
                h, stage_aux = checkpoint(period, h, stage_aux, l, use_reentrant=False)
            else:
                h, stage_aux = period(h, stage_aux, l)
        if with_aux:
            aux = aux + stage_aux
    if stacks:
        cache = {"stages": tuple(
            {key: ({**blk, **{name: torch.stack([c[name] for c in stacks[(si, key)]])
                              for name in stacks[(si, key)][0]}}
                   if (si, key) in stacks else blk)
             for key, blk in stage.items()}
            for si, stage in enumerate(cache["stages"])
        )}

    h = L.rmsnorm(params["final_norm"], h)
    if logits_mode == "last":
        h = h[:, -1:]
    # lm_head is column-parallel under TP (vocab shards): gather the whole
    # logits so sampling sees every token; the identity otherwise
    if chunked_decode:
        logits = all_gather_cols(linear(L.token_rows_view(h), params["lm_head"], out_dtype=torch.float32))
        return logits.reshape(*h.shape[:2], -1), cache, aux
    logits = all_gather_cols(linear(h, params["lm_head"], out_dtype=torch.float32))
    return logits, cache, aux
