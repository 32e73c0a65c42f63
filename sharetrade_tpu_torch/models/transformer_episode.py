"""Episode-mode transformer: the tick stream is the sequence.

Counterpart of the JAX package's ``models/transformer_episode.py``; read its
module docstring for the design. Ticks are embedded once from step-invariant
features (log-return and its magnitude), positions enter by rotary
embeddings at absolute tick indices, attention is banded causal with band
``window`` (``ops.attention.flash_attention(local_window=window)``), and the
portfolio state (budget, shares) joins at the head.

Serving runs two programs:

- :func:`_prefill` for a batch of fresh sessions: one banded pass over
  ``[first price repeated hist_len times | first window]``
  (``hist_len + window`` ticks, positions ``-hist_len .. window-1``), which
  leaves the last ``window`` rotated K/V of every layer as the session's
  cache;
- :func:`_incremental_serve` for a batch of warm sessions at heterogeneous
  episode steps: one new tick per session, written into its K/V ring at
  slot ``(t - 1) mod window`` of its own clock, then a 1 x window cache
  attention in plain PyTorch (no kernel: the JAX package has none there
  either).

Training runs the JAX package's trunk-precomputed pair and replays:

- :func:`apply_rollout_trunk`: the whole unroll's trunk in one banded pass
  over ``[history | first window | future ticks]`` (the rollout's prices do
  not depend on its actions), plus the carry after the unroll;
- :func:`rollout_head_factored` / :func:`apply_rollout_head`: the small
  state-dependent head the sequential loop applies per step;
- :func:`apply_unroll` and :func:`apply_unroll_shared`: the differentiable
  replay of a stored trajectory as one banded pass (the shared form runs it
  once for a representative row and only the head per agent). Gradients
  flow through ``flash_attention``'s backward kernels.

Carry per session: ``k``/``v`` ``(L, H, W, Dh)`` in the compute dtype,
``hist`` ``(hist_len,)`` float32 prices, ``t`` int32 step clock. Batched
carries add a leading batch dimension.

Not yet ported: the lockstep ``_incremental``/``apply_batch``/``apply``
(the generic per-step rollout), block rematerialisation, the pipelined and
MoE variants.
"""

from __future__ import annotations

import torch

from sharetrade_tpu_torch.config import ConfigError
from sharetrade_tpu_torch.device import resolve_device
from sharetrade_tpu_torch.models.core import (
    Model, ModelOut, compute_dtype, dense, dense_init, layer_norm,
    portfolio_features, rows_finite)
from sharetrade_tpu_torch.models.ffn import ffn_apply
from sharetrade_tpu_torch.ops.attention import flash_attention

_EPS = 1e-6


def _rope(x: torch.Tensor, positions: torch.Tensor, *,
          base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding. x: (B, H, S, D), D even; positions:
    (B, S) absolute tick indices (negative at episode-start padding).
    Angles in float32, result cast back to ``x``'s dtype."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[:, None, :, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _tick_features(series: torch.Tensor) -> torch.Tensor:
    """(B, S) prices -> (B, S, 3): log-return (0 for the first tick), its
    magnitude, and a zero channel."""
    logp = torch.log(torch.clamp(series, min=_EPS))
    ret = torch.cat([torch.zeros_like(logp[:, :1]),
                     logp[:, 1:] - logp[:, :-1]], dim=1)
    return torch.stack([ret, ret.abs(), torch.zeros_like(ret)], dim=-1)


def episode_transformer_policy(obs_dim: int = 203, num_actions: int = 3, *,
                               num_layers: int = 2, num_heads: int = 4,
                               head_dim: int = 64, mlp_ratio: int = 4,
                               device: torch.device | str | None = None,
                               attention_fn=None) -> Model:
    """Build the episode-mode policy.

    ``device`` is ``cuda`` when None (raises without one).
    ``attention_fn(q, k, v, window) -> out`` replaces the banded flash
    attention of every banded pass (``chip_smoke.py`` passes the plain
    version to hold the kernels' end-to-end outputs and gradients against
    it)."""
    if head_dim % 2:
        raise ConfigError(f"RoPE needs an even head_dim, got {head_dim}")
    device = resolve_device(device)
    window = obs_dim - 2                    # ticks per observation window
    hist_len = (num_layers - 1) * (window - 1)
    d_model = num_heads * head_dim
    sm_scale = head_dim ** -0.5

    def local_attention(q, k, v, w):
        return flash_attention(q, k, v, causal=True, sm_scale=sm_scale,
                               local_window=w)

    attend = attention_fn or local_attention

    def init(gen: torch.Generator) -> dict:
        """Fresh fp32 parameters, drawn from ``gen`` on the CPU (so a seed
        gives the same weights on every device) and moved to ``device``.
        Same tree and scales as the JAX init; not the same numbers."""
        def ln():
            return {"scale": torch.ones(d_model, device=device),
                    "bias": torch.zeros(d_model, device=device)}

        params = {
            "embed": dense_init(gen, 3, d_model, device=device),
            "port": dense_init(gen, 3, d_model, scale=0.02, device=device),
            "policy": dense_init(gen, d_model, num_actions, scale=0.01,
                                 device=device),
            "value": dense_init(gen, d_model, 1, device=device),
            "final_ln": ln(),
            "blocks": [],
        }
        out_scale = 0.02 / max(num_layers, 1)
        for _ in range(num_layers):
            params["blocks"].append({
                "ln1": ln(),
                "qkv": dense_init(gen, d_model, 3 * d_model, device=device),
                "proj": dense_init(gen, d_model, d_model, scale=out_scale,
                                   device=device),
                "ln2": ln(),
                "mlp_in": dense_init(gen, d_model, mlp_ratio * d_model,
                                     device=device),
                "mlp_out": dense_init(gen, mlp_ratio * d_model, d_model,
                                      scale=out_scale, device=device),
            })
        return params

    def _qkv(blk, x, positions):
        bsz, s_len = x.shape[0], x.shape[1]
        h = layer_norm(x, blk["ln1"]["scale"], blk["ln1"]["bias"])
        qkv = dense(blk["qkv"], h).reshape(bsz, s_len, 3, num_heads, head_dim)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        return _rope(q, positions), _rope(k, positions), v

    def _block_tail(blk, x, attn_out, dtype):
        bsz, s_len = x.shape[0], x.shape[1]
        attn_out = attn_out.transpose(1, 2).reshape(
            bsz, s_len, d_model).to(dtype)
        x = x + dense(blk["proj"], attn_out)
        h = layer_norm(x, blk["ln2"]["scale"], blk["ln2"]["bias"])
        return x + ffn_apply(blk, h)

    def block_apply(blk, x, positions, kv_offset=0):
        """One banded pre-LN block over (B, S, d). Returns ``(x, (k_tail,
        v_tail))``, the rotated K/V of the ``window`` ticks that end
        ``kv_offset`` ticks before the series end."""
        dtype = compute_dtype(blk)
        q, k, v = _qkv(blk, x, positions)
        x_attn = attend(q, k, v, window)
        lo = x.shape[1] - window - kv_offset
        return _block_tail(blk, x, x_attn, dtype), (
            k[:, :, lo:lo + window], v[:, :, lo:lo + window])

    def forward(params, series, positions, port_feats, *, kv_offset=0,
                heads=True):
        """Banded forward over a (B, S) tick series. ``port_feats`` (B, S,
        3) is zero except at query positions. Returns (logits (B, S, A) f32,
        values (B, S) f32, per-layer rotated (k, v) tails, hidden (B, S,
        d)). ``kv_offset`` shifts the cached window that many ticks back
        from the series end (the rollout trunk's last tick belongs to the
        bootstrap position). ``heads=False`` skips the policy/value heads
        (logits and values are then None) for the passes that only read the
        hidden state."""
        dtype = compute_dtype(params)
        x = dense(params["embed"], _tick_features(series).to(dtype))
        kv = []
        for blk in params["blocks"]:
            x, kv_tail = block_apply(blk, x, positions, kv_offset)
            kv.append(kv_tail)
        hn = layer_norm(x, params["final_ln"]["scale"],
                        params["final_ln"]["bias"])
        if not heads:
            return None, None, kv, hn
        hn_port = hn + dense(params["port"], port_feats.to(dtype))
        logits = dense(params["policy"], hn_port).float()
        values = dense(params["value"], hn_port).float()[..., 0]
        return logits, values, kv, hn

    def _prefill(params, obs):
        """Episode-start pass for a batch of fresh sessions:
        [first-price pads | first window], caching the last ``window``
        rotated K/V per layer."""
        bsz = obs.shape[0]
        win = obs[:, :window]
        series = torch.cat([win[:, :1].expand(bsz, hist_len), win], dim=1)
        positions = torch.arange(-hist_len, window, dtype=torch.int32,
                                 device=obs.device)[None, :].expand(
                                     bsz, hist_len + window)
        port = torch.zeros(series.shape + (3,), dtype=torch.float32,
                           device=obs.device)
        port[:, -1, :] = portfolio_features(obs[:, window], obs[:, window + 1],
                                            win[:, -1])
        logits, values, kv, _hn = forward(params, series, positions, port)
        carry = {
            "k": torch.stack([k for k, _ in kv], dim=1),   # (B, L, H, W, Dh)
            "v": torch.stack([v for _, v in kv], dim=1),
            "hist": win[:, :1].expand(bsz, hist_len).to(torch.float32)
                    .contiguous(),
            "t": torch.ones((bsz,), dtype=torch.int32, device=obs.device),
        }
        return ModelOut(logits=logits[:, -1], value=values[:, -1]), carry

    def _incremental_serve(params, obs, carry):
        """One-token step for a batch of warm sessions (t >= 1) at
        heterogeneous episode steps. Writes each session's new rotated K/V
        into its own ring slot ``(t - 1) mod window``; updates ``carry`` in
        place (the engine hands it a gathered copy of the arena rows) and
        returns it."""
        bsz = obs.shape[0]
        dtype = compute_dtype(params)
        new, prev = obs[:, window - 1], obs[:, window - 2]
        ret = (torch.log(torch.clamp(new, min=_EPS))
               - torch.log(torch.clamp(prev, min=_EPS)))
        tok = torch.stack([ret, ret.abs(), torch.zeros_like(ret)], dim=-1)
        x = dense(params["embed"], tok.to(dtype))[:, None, :]      # (B, 1, d)
        t = carry["t"]
        pos = (t + window - 1).to(torch.int32)[:, None]            # (B, 1)
        slots = torch.remainder(t - 1, window).long()              # (B,)
        rows = torch.arange(bsz, device=obs.device)
        k_cache, v_cache = carry["k"], carry["v"]                  # (B,L,H,W,Dh)
        for li, blk in enumerate(params["blocks"]):
            q, k, v = _qkv(blk, x, pos)                            # (B,H,1,Dh)
            k_cache[rows, li, :, slots] = k[:, :, 0]
            v_cache[rows, li, :, slots] = v[:, :, 0]
            k_all, v_all = k_cache[:, li], v_cache[:, li]          # (B,H,W,Dh)
            s = torch.matmul(q.float(), k_all.float().transpose(-1, -2)) \
                * sm_scale
            probs = torch.softmax(s, dim=-1).to(v_all.dtype)
            x = _block_tail(blk, x, torch.matmul(probs, v_all), dtype)
        hn = layer_norm(x[:, 0], params["final_ln"]["scale"],
                        params["final_ln"]["bias"])
        hn = hn + dense(params["port"], portfolio_features(
            obs[:, window], obs[:, window + 1], new).to(dtype))
        logits = dense(params["policy"], hn).float()
        values = dense(params["value"], hn).float()[..., 0]
        if hist_len:
            # Tick t (the window's oldest) leaves the window this step.
            carry["hist"] = torch.cat([carry["hist"][:, 1:], obs[:, :1]],
                                      dim=1)
        carry["t"] = t + 1
        return ModelOut(logits=logits, value=values), carry

    def _series(hist, first_win, ticks, t0):
        """[history | first window | ticks] and absolute positions, with the
        first-price padding substituted for the history at episode start
        (t == 0: the carry's zeros are not what the prefill saw)."""
        hist = torch.where((t0 == 0)[:, None], first_win[:, :1], hist)
        series = torch.cat([hist, first_win, ticks.to(torch.float32)], dim=1)
        positions = (t0[:, None] - hist_len + torch.arange(
            series.shape[1], dtype=torch.int32, device=series.device))
        return series, positions.to(torch.int32)

    def apply_unroll(params, obs, carry):
        """Training replay: ONE banded pass over [history | chunk ticks].
        ``obs`` (T, B, obs_dim) is the stored trajectory, ``carry`` the
        batched carry at unroll start. Returns (logits (T, B, A), values
        (T, B), aux 0)."""
        t_len, bsz = obs.shape[0], obs.shape[1]
        first_win = obs[0, :, :window]                      # (B, W)
        newer = obs[1:, :, window - 1].T                    # (B, T-1)
        t0 = carry["t"].to(torch.int32)
        series, positions = _series(carry["hist"], first_win, newer, t0)
        s_len = series.shape[1]
        q0 = hist_len + window - 1                          # query positions
        anchor = obs[:, :, window - 1]
        feats = portfolio_features(obs[:, :, window], obs[:, :, window + 1],
                                   anchor)                  # (T, B, 3)
        port = torch.zeros((bsz, s_len, 3), dtype=torch.float32,
                           device=obs.device)
        port[:, q0:q0 + t_len] = feats.transpose(0, 1)
        logits, values, _kv, _hn = forward(params, series, positions, port)
        return (logits[:, q0:q0 + t_len].transpose(0, 1),
                values[:, q0:q0 + t_len].transpose(0, 1),
                torch.zeros((), device=obs.device))

    def _head_fold(params):
        """The (3 -> A) / (3 -> 1) folded portfolio-head matrices of the
        factored head, in float32 from the compute-copy leaves: shared by
        :func:`rollout_head_factored` and :func:`apply_unroll_shared` so
        their op order (and so their bf16 rounding) cannot diverge.
        Differentiable."""
        wp = params["port"]["w"].float()
        bp = params["port"]["b"].float()
        wl = params["policy"]["w"].float()
        wv = params["value"]["w"].float()
        return wp @ wl, bp @ wl, (wp @ wv)[:, 0], (bp @ wv)[0]

    def apply_unroll_shared(params, obs, carry):
        """:func:`apply_unroll` with the banded pass run ONCE for a
        representative row: every healthy agent's price series is the same
        (the lockstep batch), so only the portfolio head runs per agent.
        The representative is the row with the most healthy steps (anchor
        price > 0) among rows whose unroll-start carry is finite — the first
        such row, as ``argmax`` gives — and is chosen on the device (no
        host sync)."""
        t_len, bsz = obs.shape[0], obs.shape[1]
        counts = (obs[:, :, window - 1] > 0).sum(dim=0)               # (B,)
        carry_ok = rows_finite(carry, bsz)
        rep = torch.argmax(torch.where(carry_ok, counts,
                                       torch.full_like(counts, -1)))
        rep = rep.reshape(1)
        obs1 = obs.index_select(1, rep)                               # (T,1,·)
        carry1 = {k: v.index_select(0, rep) for k, v in carry.items()}
        first_win = obs1[0, :, :window]
        newer = obs1[1:, :, window - 1].T
        t0 = carry1["t"].to(torch.int32)
        series, positions = _series(carry1["hist"], first_win, newer, t0)
        _l, _v, _kv, hn = forward(params, series, positions, None,
                                  heads=False)
        q0 = hist_len + window - 1
        hn_q = hn[0, q0:q0 + t_len]                                   # (T, d)
        # Per-agent head in the same factored form (and op order) as the
        # rollout's, so stored and replayed logp agree to rounding in bf16.
        base_l = dense(params["policy"], hn_q).float()                # (T, A)
        base_v = dense(params["value"], hn_q).float()[..., 0]
        w_pl, b_pl, w_pv, b_pv = _head_fold(params)
        anchor = obs[:, :, window - 1]                                # (T, B)
        feats = portfolio_features(obs[:, :, window], obs[:, :, window + 1],
                                   anchor).float()
        logits = base_l[:, None] + feats @ w_pl + b_pl
        values = base_v[:, None] + feats @ w_pv + b_pv
        return logits, values, torch.zeros((), device=obs.device)

    def apply_rollout_trunk(params, obs, future_ticks, carry):
        """The whole unroll's trunk in ONE banded pass. ``future_ticks`` (B,
        T) are the ticks that enter the window at each of the next T steps.
        Returns (hn_base (B, T+1, d) — row i serves step t0+i, row T the
        bootstrap value — and the carry after T steps, its K/V in ring
        layout so an incremental step continues from it)."""
        bsz, t_len = future_ticks.shape
        t0 = carry["t"].to(torch.int32)
        first_win = obs[:, :window]
        series, positions = _series(carry["hist"], first_win, future_ticks,
                                    t0)
        _l, _v, kv, hn = forward(params, series, positions, None,
                                 kv_offset=1, heads=False)
        q0 = hist_len + window - 1
        hn_base = hn[:, q0:q0 + t_len + 1]
        # The cached window (kv_offset=1) holds ticks [t_end-1, t_end+W-2]
        # in series order; the ring keeps tick j at slot j mod W, so roll by
        # (t_end - 1) mod W — as a gather, to keep the shift on the device.
        t_end = t0 + t_len
        shift = torch.remainder(t_end[0] - 1, window)
        ring = torch.remainder(
            torch.arange(window, device=obs.device) - shift, window)
        cache_k = torch.stack([k for k, _ in kv], dim=1).index_select(3, ring)
        cache_v = torch.stack([v for _, v in kv], dim=1).index_select(3, ring)
        hist_next = (series[:, t_len:t_len + hist_len] if hist_len
                     else carry["hist"])
        return hn_base, {"k": cache_k, "v": cache_v, "hist": hist_next,
                         "t": t_end}

    def apply_rollout_head(params, hn_row, obs):
        """The state-dependent rest of the forward: inject the portfolio
        features and read the policy/value heads — (B, d)-sized ops."""
        dtype = compute_dtype(params)
        hn = hn_row.to(dtype) + dense(params["port"], portfolio_features(
            obs[:, window], obs[:, window + 1], obs[:, window - 1]).to(dtype))
        logits = dense(params["policy"], hn).float()
        values = dense(params["value"], hn).float()[..., 0]
        return ModelOut(logits=logits, value=values)

    def rollout_head_factored(params, hn_base):
        """The rollout head with its linearity used: dense(policy, hn +
        dense(port, feats)) == dense(policy, hn) + [feats @ (Wp Wl) + bp
        Wl]. The first term is one (T+1, d) x (d, A) product over the whole
        unroll's trunk; the second is a (3 -> A) contraction per step."""
        dtype = compute_dtype(params)
        base_logits = dense(params["policy"], hn_base.to(dtype)).float()
        base_values = dense(params["value"], hn_base.to(dtype)).float()[..., 0]
        w_pl, b_pl, w_pv, b_pv = _head_fold(params)

        def pf_fn(obs):
            feats = portfolio_features(obs[:, window], obs[:, window + 1],
                                       obs[:, window - 1]).float()
            return feats @ w_pl + b_pl, feats @ w_pv + b_pv

        return base_logits, base_values, pf_fn

    def init_carry():
        return {
            "k": torch.zeros((num_layers, num_heads, window, head_dim),
                             device=device),
            "v": torch.zeros((num_layers, num_heads, window, head_dim),
                             device=device),
            "hist": torch.zeros((hist_len,), device=device),
            "t": torch.zeros((), dtype=torch.int32, device=device),
        }

    def cast_carry(carry, to_dtype):
        """K/V follow the compute dtype; ``hist`` stays float32 (raw prices
        the prefill always rebuilds from float32 observations)."""
        out = dict(carry)
        out["k"] = carry["k"].to(to_dtype)
        out["v"] = carry["v"].to(to_dtype)
        return out

    return Model(init=init, init_carry=init_carry, apply_prefill=_prefill,
                 apply_serve_batch=_incremental_serve, cast_carry=cast_carry,
                 obs_dim=obs_dim, name="transformer_episode", device=device,
                 num_actions=num_actions, apply_unroll=apply_unroll,
                 apply_unroll_shared=apply_unroll_shared,
                 apply_rollout_trunk=apply_rollout_trunk,
                 apply_rollout_head=apply_rollout_head,
                 rollout_head_factored=rollout_head_factored)
