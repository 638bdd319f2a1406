"""Plain PyTorch versions of the hand-written kernels (the correctness
contracts).

Each ``ref_*`` is the mathematically plain implementation of what one
kernel computes, mirroring the JAX package's ``kernels/ref.py`` oracles.
A kernel wrapper takes its plain version for CPU tensors only; on the card
``chip_smoke.py`` holds every kernel against it.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def ref_confidence(logits: torch.Tensor):
    """Fused softmax-confidence oracle.  logits: (B, V) ->
    (argmax (B,) int32, delta (B,) f32) per Defs. 3.2-3.3.  ``argmax``
    returns the first index of the maximum."""
    x = logits.float()
    idx = torch.argmax(x, dim=-1).to(torch.int32)
    m = torch.amax(x, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(x - m[..., None]), dim=-1))
    return idx, torch.exp(m - lse)


def ref_rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """x: (R, d); w: (d,).  Scale by w in f32, then cast."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * w.float()).to(x.dtype)


def ref_flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B, H, S, hd); k, v: (B, KV, S, hd).  GQA by head grouping."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    qpk = H // KV
    qh = q.reshape(B, KV, qpk, S, hd).float()
    s = torch.einsum("bkgqh,bksh->bkgqs", qh, k.float()) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)


def ref_decode_attention(q, k_cache, v_cache, t, kpos, window: int = 0,
                         live=None):
    """q: (B, H, hd); caches: (B, W, KV, hd); t the position (an int or
    a 0-d int32 tensor); kpos (W,) or per-slot (B, W); live (B,) bool or
    None.  Dead slots' output rows are exact zeros; live rows are the
    plain ring-masked single-query attention."""
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    qpk = H // KV
    qh = q.reshape(B, KV, qpk, hd).float()
    s = torch.einsum("bkgh,bwkh->bkgw", qh, k_cache.float()) / math.sqrt(hd)
    kp = kpos if kpos.dim() == 2 else kpos[None]
    m = (kp >= 0) & (kp <= t)
    if window:
        m = m & (kp > t - window)
    s = torch.where(m[:, None, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkh->bkgh", p, v_cache.float()).reshape(B, H, hd)
    if live is not None:
        o = torch.where(live.bool()[:, None, None], o, torch.zeros_like(o))
    return o.to(q.dtype)


def _rows(cache, table, w0: int, w1: int):
    """Rows [w0, w1) of every slot's keys or values: (B, w1 - w0, KV, hd).
    Dense: the slice of the (B, W, KV, hd) cache.  Paged (``table`` (B,
    nblk)): row w of slot b read from the store (NB, bs, KV, hd) at
    (table[b, w // bs], w % bs), as the kernel's paged tile loads address
    it."""
    if table is None:
        return cache[:, w0:w1]
    w = torch.arange(w0, w1)
    bs = cache.shape[1]
    return cache[table[:, w // bs].long(), w % bs]


def ref_decode_attention_split(q, k_cache, v_cache, t, kpos, live=None, *,
                               window: int = 0, chunk: int = 32, table=None):
    """Plain emulation of the split-KV decode kernel's arithmetic (tests
    only): per chunk of ``chunk`` keys the partial (m, l, acc) of an f32
    softmax, a chunk with no visible key of its slot skipped as the empty
    partial (-1e30, 0, 0), then the partials merged in ascending chunk
    order: M = max m, L = sum l * exp(m - M), acc = sum acc * exp(m - M),
    out = acc / max(L, 1e-30).  A live row with no visible key gets the
    plain softmax's uniform weights (the mean of V over W); dead rows are
    exact zeros.  Same arguments as :func:`ref_decode_attention`; with
    ``table`` ((B, nblk) int32) the caches are a layer's paged stores (NB,
    bs, KV, hd), W = nblk * bs, and every row is read through the table
    (the kernel's ``paged`` route)."""
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    W = k_cache.shape[1] * (table.shape[1] if table is not None else 1)
    qh = q.reshape(B, KV, H // KV, hd).float()
    kp = (kpos if kpos.dim() == 2 else kpos[None]).expand(B, W)
    vis = (kp >= 0) & (kp <= t)
    if window:
        vis = vis & (kp > t - window)
    scale = 1.0 / math.sqrt(hd)
    parts = []
    for w0 in range(0, W, chunk):
        sl = slice(w0, min(W, w0 + chunk))
        vm = vis[:, sl][:, None, None, :]
        s = torch.einsum("bkgh,bwkh->bkgw", qh,
                         _rows(k_cache, table, sl.start, sl.stop).float())
        s = torch.where(vm, s * scale, torch.full_like(s, NEG))
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        acc = torch.einsum("bkgw,bwkh->bkgh", p,
                           _rows(v_cache, table, sl.start, sl.stop).float())
        empty = ~vm.any(-1)
        parts.append((torch.where(empty, torch.full_like(m, NEG), m),
                      torch.where(empty, torch.zeros_like(m), p.sum(-1)),
                      torch.where(empty[..., None], torch.zeros_like(acc),
                                  acc)))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        f = torch.exp(m - M)
        L = L + l * f
        acc = acc + a * f[..., None]
    o = acc / torch.clamp(L, min=1e-30)[..., None]
    none = ~vis.any(-1)[:, None, None, None]
    mean = _rows(v_cache, table, 0, W).float().mean(1)[:, :, None, :]
    o = torch.where(none, mean.expand_as(o), o).reshape(B, H, hd)
    if live is not None:
        o = torch.where(live.bool()[:, None, None], o, torch.zeros_like(o))
    return o.to(q.dtype)


def ref_exit_update(logits, answered, pred, exit_idx, conf, streak, ema,
                    active, *, threshold, m, n_components, patience_k=0,
                    ema_decay=0.0, tel_bins=0):
    """Fused exit-update oracle: one component step of the decision scan
    (:meth:`repro_torch.core.policy.ExitDecider.scan_component` semantics)
    plus the optional DecodeState confidence-EMA fold.  ``tel_bins > 0``
    appends the packed telemetry code of the raw prediction/confidence."""
    idx, delta = ref_confidence(logits)
    return _carry_merge(idx, delta, answered, pred, exit_idx, conf, streak,
                        ema, active, threshold=threshold, m=m,
                        n_components=n_components, patience_k=patience_k,
                        ema_decay=ema_decay, tel_bins=tel_bins)


def _carry_merge(idx, delta, answered, pred, exit_idx, conf, streak, ema,
                 active, *, threshold, m, n_components, patience_k=0,
                 ema_decay=0.0, tel_bins=0):
    """The exit-update step given each row's prediction and confidence.
    ``threshold`` is a float or an f32 tensor: 0-d, or the
    ``(n_components,)`` vector whose element ``m`` gates (both compared at
    f32, as the kernels compare)."""
    last = m >= n_components - 1
    # final component: gate open BEFORE the patience rewrite (dense order)
    if last:
        gate = torch.ones_like(delta, dtype=torch.bool)
    else:
        if isinstance(threshold, torch.Tensor) and threshold.dim() == 1:
            threshold = threshold[m]
        gate = delta >= threshold
    streak_n = streak.to(torch.int32)
    if patience_k > 0:
        streak_n = torch.where(gate, streak_n + 1, torch.zeros_like(streak_n))
        gate = streak_n >= patience_k
        if last:
            gate = torch.ones_like(gate)
    answered = answered.bool()
    fresh = gate & ~answered
    conf_n = torch.where(fresh, delta, conf.float())
    ema_n = ema.float()
    if ema_decay > 0.0:
        ema_n = torch.where(active.bool(),
                            ema_decay * ema_n + (1.0 - ema_decay) * conf_n,
                            ema_n)
    outs = (answered | gate,
            torch.where(fresh, idx, pred.to(torch.int32)),
            torch.where(fresh, torch.full_like(idx, m),
                        exit_idx.to(torch.int32)),
            conf_n, streak_n, ema_n)
    if tel_bins:
        from repro_torch.autotune.telemetry import pack_rider
        outs += (pack_rider(idx, delta, tel_bins),)
    return outs


def _pass_dead(outs, live, answered, pred, exit_idx, conf, streak, ema,
               tel_bins):
    """Dead (``live`` False) rows keep every carry and get telemetry code 0
    (the megakernel's contract — a retired slot's outputs are never
    read)."""
    if live is None:
        return outs
    lv = live.bool()
    carry_in = (answered.bool(), pred.to(torch.int32),
                exit_idx.to(torch.int32), conf.float(),
                streak.to(torch.int32), ema.float())
    kept = tuple(torch.where(lv, o, i) for o, i in zip(outs, carry_in))
    if tel_bins:
        kept += (torch.where(lv, outs[6], torch.zeros_like(outs[6])),)
    return kept


def ref_exit_head_update(h, norm_w, head, answered, pred, exit_idx, conf,
                         streak, ema, active, *, threshold, m, n_components,
                         patience_k=0, ema_decay=0.0, tel_bins=0, eps=1e-5,
                         live=None):
    """Fused exit-head megakernel oracle: the kernel-route rmsnorm (scale
    by w in f32, one cast) -> the head product in the model dtype ->
    :func:`ref_exit_update`, with dead (``live`` False) rows passing every
    carry through unchanged and getting telemetry code 0."""
    x = ref_rmsnorm(h, norm_w, eps)
    logits = (x @ head.to(x.dtype)).float()
    outs = ref_exit_update(logits, answered, pred, exit_idx, conf, streak,
                           ema, active, threshold=threshold, m=m,
                           n_components=n_components, patience_k=patience_k,
                           ema_decay=ema_decay, tel_bins=tel_bins)
    return _pass_dead(outs, live, answered, pred, exit_idx, conf, streak,
                      ema, tel_bins)


# ---------------------------------------------------------------------------
# emulators of the redesigned kernels' arithmetic (tests only)
# ---------------------------------------------------------------------------

def ref_rmsnorm_warp(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    """Plain emulation of the warp-per-row norm (``csrc/common.cuh``
    warp_row_load / warp_row_rs / warp_row_scale; rmsnorm's ``warp`` route
    and the megakernel's prologues): lane l holds the 16-byte chunks c = l + 32 j
    of the row, sums its elements' squares in load order in f32 (each step
    one fused multiply-add, emulated in f64 and rounded), the lanes meet in
    a xor tree (offsets 16, 8, 4, 2, 1), rs = 1 / sqrt(sum / d + eps) in
    f32; then ``(x * rs) * w`` in f32 and one cast.  x: (R, d) with d a
    whole number of 16-byte chunks."""
    R, d = x.shape
    kvec = 16 // x.element_size()
    n_c = d // kvec
    nv = -(-n_c // 32)
    x32 = x.float()
    # (R, 32 lanes, nv chunks, kvec) in each lane's load order, zero-padded
    padded = torch.zeros((R, nv * 32 * kvec), dtype=torch.float32)
    padded[:, :d] = x32
    lanes = padded.reshape(R, nv, 32, kvec).permute(0, 2, 1, 3) \
        .reshape(R, 32, nv * kvec).double()
    ss = torch.zeros((R, 32), dtype=torch.float32)
    for i in range(nv * kvec):
        v = lanes[:, :, i]
        ss = (ss.double() + v * v).float()
    for o in (16, 8, 4, 2, 1):
        ss = ss + ss[:, torch.arange(32) ^ o]
    mean = ss[:, :1] / torch.tensor(float(d), dtype=torch.float32)
    rs = 1.0 / torch.sqrt((mean + torch.tensor(eps, dtype=torch.float32))
                          .double())
    return ((x32 * rs.float()) * w.float()).to(x.dtype)


def ref_exit_head_update_tc(h, norm_w, head, answered, pred, exit_idx, conf,
                            streak, ema, active, *, threshold, m,
                            n_components, n_ctas, patience_k=0,
                            ema_decay=0.0, tel_bins=0, eps=1e-5, live=None):
    """Plain emulation of the megakernel's ``tc`` route (tests only): xn
    from :func:`ref_rmsnorm_warp`, rounded to the model dtype; each logit
    the f32 sum of the k16 steps' partial products (each step's 16
    products summed exactly, then rounded to f32 and added in k order);
    each logit rounded to the model dtype; per CTA the vocab range of
    ``megakernel.plan(V, n_ctas)`` folded into one (max, Σexp,
    first-argmax) partial; the partials merged in CTA order; then the
    exit-update step with dead rows passing their carries through."""
    from repro_torch.kernels.megakernel import plan
    xn = ref_rmsnorm_warp(h, norm_w, eps)
    B, d = xn.shape
    V = head.shape[1]
    x64, w64 = xn.double(), head.double()
    logits = torch.zeros((B, V), dtype=torch.float32)
    for k0 in range(0, d, 16):
        step = x64[:, k0:k0 + 16] @ w64[k0:k0 + 16]
        logits = logits + step.float()
    if h.dtype != torch.float32:
        logits = logits.to(h.dtype).float()
    idx, delta = _split_confidence(logits, plan(V, n_ctas))
    outs = _carry_merge(idx, delta, answered, pred, exit_idx, conf, streak,
                        ema, active, threshold=threshold, m=m,
                        n_components=n_components, patience_k=patience_k,
                        ema_decay=ema_decay, tel_bins=tel_bins)
    return _pass_dead(outs, live, answered, pred, exit_idx, conf, streak,
                      ema, tel_bins)


def _split_confidence(logits, ranges):
    """The confidence of a vocab split over CTAs: per column range [c0, c1)
    of ``ranges`` one (max, Σexp, first-argmax) partial of the f32 logits
    (an empty range gives the empty partial), then the partials merged in
    range order — M = max m, L = Σ l·exp(m − M), the first index among
    the partials at M.  Returns (argmax (B,) int32, δ = 1 / L (B,) f32)."""
    B = logits.shape[0]
    ms, ls, as_ = [], [], []
    for c0, c1 in ranges:
        if c0 == c1:
            ms.append(torch.full((B,), NEG))
            ls.append(torch.zeros(B))
            as_.append(torch.full((B,), 2 ** 31 - 1, dtype=torch.int64))
            continue
        part = logits[:, c0:c1]
        mx = part.amax(-1)
        ms.append(mx)
        ls.append(torch.exp(part - mx[:, None]).sum(-1))
        as_.append(c0 + torch.argmax(part, -1))
    M = torch.stack(ms).amax(0)
    L = torch.zeros(B)
    idx = torch.full((B,), 2 ** 31 - 1, dtype=torch.int64)
    for mc, lc, ac in zip(ms, ls, as_):
        L = L + lc * torch.exp(mc - M)
        idx = torch.where((mc == M) & (ac < idx), ac, idx)
    return idx.to(torch.int32), 1.0 / L


def ref_confidence_cluster(logits, C: int):
    """Plain emulation of the confidence kernel's cluster split (tests
    only): each row's f32 logits cut into the C column ranges of
    ``confidence.ranges(V, C)`` (one per CTA of the row's cluster), one
    (max, Σexp, first-argmax) partial per range, the partials merged in
    rank order (:func:`_split_confidence`).  Returns (argmax (B,) int32,
    δ (B,) f32), as :func:`ref_confidence`."""
    from repro_torch.kernels.confidence import ranges
    return _split_confidence(logits.float(), ranges(logits.shape[1], C))


def ref_exit_update_split(logits, answered, pred, exit_idx, conf, streak,
                          ema, active, *, threshold, m, n_components,
                          patience_k=0, ema_decay=0.0, tel_bins=0,
                          tile: int = 4096):
    """Plain emulation of the split exit-update kernel (tests only): the
    f32 logits of each row cut into ``tile``-column tiles (the last one
    partial), one (max, Σexp, first-argmax) partial per tile, the partials
    merged in ascending tile order (:func:`_split_confidence`), then the
    exit-update step of :func:`ref_exit_update`.  Same arguments and
    results as :func:`ref_exit_update`."""
    V = logits.shape[1]
    idx, delta = _split_confidence(
        logits.float(), [(j, min(V, j + tile)) for j in range(0, V, tile)])
    return _carry_merge(idx, delta, answered, pred, exit_idx, conf, streak,
                        ema, active, threshold=threshold, m=m,
                        n_components=n_components, patience_k=patience_k,
                        ema_decay=ema_decay, tel_bins=tel_bins)


def ref_cohort_scatter(dst, src, c: int, C: int):
    """Cohort scatter oracle, in place: ``dst[:, c*Bc:(c+1)*Bc] = src``
    with ``Bc = B // C`` (dst (L, B, ...), src (L, Bc, ...)).  Returns
    dst."""
    Bc = dst.shape[1] // C
    dst[:, c * Bc:(c + 1) * Bc] = src
    return dst


def ref_cohort_scatter_slot(dst, src, c: int, C: int, slot):
    """Slot-route cohort scatter oracle, in place: ``dst[:, c*Bc:(c+1)*Bc,
    slot] = src[:, :, 0]`` (dst (L, B, W, ...), src (L, Bc, 1, ...), slot a
    0-d int64 tensor).  Returns dst."""
    Bc = dst.shape[1] // C
    dst[:, c * Bc:(c + 1) * Bc].index_copy_(2, slot.view(1), src)
    return dst


def ref_paged_gather(store, table):
    """Paged gather oracle: store (NB, bs, kv, hd) gathered through table
    (B, nblk) -> the slot-logical ring view (B, nblk * bs, kv, hd)."""
    B, nblk = table.shape
    return store[table.long()].reshape((B, nblk * store.shape[1])
                                       + store.shape[2:])
