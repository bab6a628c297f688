"""Plain PyTorch versions of decode attention (mirror of the JAX
``ref.py``).  The contiguous :func:`decode_attention_ref` is the JAX oracle
as it is: a row with ``lengths == 0`` returns the mean of V over all S
positions, as the JAX contiguous kernel does.  The paged versions differ
from the JAX oracle in one deliberate place: rows with ``lengths == 0``
return zeros, as the paged kernels (JAX's and the port's) do.

:func:`decode_attention_split_ref` and
:func:`paged_decode_attention_split_ref` are the CUDA kernels' split form
written out: per-split online-softmax states, combined in split order;
they equal :func:`decode_attention_ref` and
:func:`paged_decode_attention_ref` up to the fp32 order of the sums (the
paged one over int8 pools dequantizes in fp32, as the kernels do)."""
import torch

NEG_INF = -1e30


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Materialise the logical contiguous view of a paged KV pool.

    pages: (P_pool, page_size, H, D) (or a scale pool (P_pool, page_size,
    H)); block_tables: (B, P_max) int -> (B, P_max * page_size, H, D).  Row
    ``b``'s logical token ``t`` lives at
    ``pages[block_tables[b, t // page_size], t % page_size]``.
    """
    b, p_max = block_tables.shape
    g = pages[block_tables.reshape(-1).long()]
    return g.reshape(b, p_max * pages.shape[1], *pages.shape[2:])


def _attend(q, k, v, lengths, zero_dead: bool, live=None):
    """fp32 masked softmax attention of one query token, rounded once to
    ``q.dtype``.  Query head ``h`` reads kv head ``h // G``.  Positions at
    or past ``lengths`` (or outside ``live`` (B, S), where given) score
    -1e30; with ``zero_dead`` they also get weight exactly 0 (and the sum is
    divided by ``max(l, 1e-30)``), so a row of length 0 is zero; without it
    such a row weighs every position alike."""
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    kt = k.permute(0, 2, 1, 3).float()                  # (B,Hkv,S,D)
    vt = v.permute(0, 2, 1, 3).float()
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, kt) / (d ** 0.5)
    if live is None:
        live = (torch.arange(s, device=q.device)[None]
                < lengths.to(q.device)[:, None])
    live = live[:, None, None]
    scores = torch.where(live, scores, NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    if zero_dead:
        p = torch.where(live, p, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p, vt) / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention_ref(q, k, v, lengths):
    """q: (B,Hq,D); k/v: (B,S,Hkv,D); lengths: (B,) -> (B,Hq,D).  The JAX
    oracle of the contiguous kernel: fp32 throughout, one rounding to
    ``q.dtype``; a row of length 0 is the mean of V."""
    return _attend(q, k, v, lengths, zero_dead=False)


def _paged_live(block_tables, p_pool: int, ps: int, lengths):
    """The tables with entries outside ``[0, p_pool)`` sent to page 0, and
    the live positions (B, P_max * ps): walked (below the length, clamped
    to the table width) and on an entry inside the pool."""
    tables = block_tables.long()
    in_pool = (tables >= 0) & (tables < p_pool)
    pos = torch.arange(tables.shape[1] * ps, device=tables.device)[None]
    lens = lengths.to(tables.device).long()[:, None]
    return (torch.where(in_pool, tables, 0),
            (pos < lens) & in_pool.repeat_interleave(ps, dim=1))


def paged_decode_attention_ref(q, k_pages, v_pages, lengths, block_tables):
    """q: (B,Hq,D); k/v_pages: (P_pool,ps,Hkv,D); lengths: (B,);
    block_tables: (B,P_max) -> (B,Hq,D).  Gather-then-attend version of the
    paged kernel: positions past ``lengths`` (incl. anything routed through
    the null page) and positions whose table entry lies outside the pool
    are masked before the softmax; a row of length 0 is zero."""
    tables, live = _paged_live(block_tables, k_pages.shape[0],
                               k_pages.shape[1], lengths)
    return _attend(q, gather_pages(k_pages, tables),
                   gather_pages(v_pages, tables), lengths, zero_dead=True,
                   live=live.to(q.device))


def paged_decode_attention_q_ref(q, k_pages, v_pages, k_scales, v_scales,
                                 lengths, block_tables):
    """int8-KV version: dequantize the gathered pages (per-(page slot,
    head) fp32 scales over the head dim), round them to ``q.dtype`` as the
    JAX oracle does, then attend as :func:`paged_decode_attention_ref`.
    (The kernel keeps the dequantized values in fp32.)"""
    tables, live = _paged_live(block_tables, k_pages.shape[0],
                               k_pages.shape[1], lengths)
    k = (gather_pages(k_pages, tables).float()
         * gather_pages(k_scales, tables)[..., None])
    v = (gather_pages(v_pages, tables).float()
         * gather_pages(v_scales, tables)[..., None])
    return _attend(q, k.to(q.dtype), v.to(q.dtype), lengths, zero_dead=True,
                   live=live.to(q.device))


def split_range(s: int, splits: int, step: int = 32) -> int:
    """Positions per split of the contiguous kernel: whole ``step``-token
    steps, ``ceil(ceil(S / step) / splits) * step``; the last splits may be
    short or empty."""
    return -(-(-(-s // step)) // splits) * step


def _split_states(q, k, v, present, scored, splits: int, step: int):
    """Per-split ``(m, l, acc)`` of one query token over k/v (B,S,Hkv,D)
    (fp32 or wider types): split ``i`` takes the positions of
    ``[i * range, (i + 1) * range)`` (:func:`split_range`) that are
    ``present`` (B,S); a present position scores q·k where ``scored``, else
    -1e30, and weighs ``exp(score - m)``; any other weighs exactly 0."""
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float() * (1.0 / d ** 0.5)
    kt = k.permute(0, 2, 1, 3).float()                  # (B,Hkv,S,D)
    vt = v.permute(0, 2, 1, 3).float()
    scores = torch.where(scored[:, None, None],
                         torch.einsum("bhgd,bhsd->bhgs", qg, kt), NEG_INF)
    pos = torch.arange(s, device=q.device)
    rng = split_range(s, splits, step)
    states = []
    for i in range(splits):
        member = (present & (pos[None] // rng == i))[:, None, None]
        m = torch.where(member, scores, NEG_INF).amax(-1, keepdim=True)
        p = torch.where(member, torch.exp(scores - m), 0.0)
        states.append((m, p.sum(-1, keepdim=True),
                       torch.einsum("bhgs,bhsd->bhgd", p, vt)))
    return states


def decode_split_states(q, k, v, lengths, splits: int, step: int = 32):
    """The per-split states of the contiguous kernel's split form.

    Row ``b`` walks its first ``lengths[b]`` positions, or all S when
    ``lengths[b] == 0``; split ``i`` takes the walked positions in
    ``[i * range, (i + 1) * range)`` (:func:`split_range`).  A position at
    or past the length scores -1e30.  Returns one ``(m, l, acc)`` per split,
    fp32 (B, Hkv, G, 1), (B, Hkv, G, 1), (B, Hkv, G, D): the max score, the
    sum of ``exp(score - m)`` and the weighted sum of V over the split's
    positions; a split with no position keeps m = -1e30, l = 0, acc = 0."""
    s = k.shape[1]
    pos = torch.arange(s, device=q.device)[None]
    lens = lengths.to(q.device).long().clamp(0, s)[:, None]
    walk = torch.where(lens > 0, lens, s)
    return _split_states(q, k, v, pos < walk, pos < lens, splits, step)


def paged_decode_split_states(q, k_pages, v_pages, lengths, block_tables,
                              splits: int, k_scales=None, v_scales=None,
                              step: int = 32):
    """The per-split states of the paged kernels' split form.

    Row ``b`` walks its first ``lengths[b]`` logical positions (clamped to
    the table width ``P_max * ps``); position ``t`` lives at
    ``pages[block_tables[b, t // ps], t % ps]``, and is live when it is
    walked and its table entry lies in ``[0, P_pool)``.  Split ``i`` takes
    the live positions of ``[i * range, (i + 1) * range)`` (``range`` from
    the table width, :func:`split_range`); dead ones weigh exactly 0, so a
    row of length 0 keeps m = -1e30, l = 0, acc = 0 in every split.  With
    ``k_scales``/``v_scales`` the pools are int8 and a value is
    ``code * scale`` in fp32.  Returns one ``(m, l, acc)`` per split, as
    :func:`decode_split_states`."""
    tables, live = _paged_live(block_tables, k_pages.shape[0],
                               k_pages.shape[1], lengths)
    k, v = gather_pages(k_pages, tables), gather_pages(v_pages, tables)
    if k_scales is not None:
        k = k.float() * gather_pages(k_scales, tables)[..., None]
        v = v.float() * gather_pages(v_scales, tables)[..., None]
    live = live.to(q.device)
    return _split_states(q, k, v, live, live, splits, step)


def combine_split_states(states):
    """The kernel's combine: ``M = max m_i``, then in split order
    ``L = sum exp(m_i - M) l_i``, ``A = sum exp(m_i - M) acc_i``; returns
    ``A / max(L, 1e-30)``, fp32 (B, Hkv, G, D)."""
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    lsum, asum = 0.0, 0.0
    for m, l, acc in states:
        c = torch.exp(m - mx)
        lsum = lsum + c * l
        asum = asum + c * acc
    return asum / torch.clamp(lsum, min=1e-30)


def decode_attention_split_ref(q, k, v, lengths, splits: int,
                               step: int = 32):
    """q: (B,Hq,D); k/v: (B,S,Hkv,D); lengths: (B,) -> (B,Hq,D), rounded
    once to ``q.dtype``: :func:`decode_attention_ref` computed as the CUDA
    kernel splits it (``splits`` states, combined in split order); a row of
    length 0 is the mean of V."""
    out = combine_split_states(decode_split_states(q, k, v, lengths, splits,
                                                   step))
    return out.reshape(q.shape).to(q.dtype)


def paged_decode_attention_split_ref(q, k_pages, v_pages, lengths,
                                     block_tables, splits: int,
                                     k_scales=None, v_scales=None,
                                     step: int = 32):
    """q: (B,Hq,D); k/v_pages: (P_pool,ps,Hkv,D) (int8 with fp32
    ``k_scales``/``v_scales`` (P_pool,ps,Hkv)); lengths: (B,); block_tables:
    (B,P_max) -> (B,Hq,D), rounded once to ``q.dtype``: the paged kernels'
    split form (:func:`paged_decode_split_states`, combined in split
    order).  A row of length 0 is zero; a table entry outside the pool is a
    dead position."""
    out = combine_split_states(paged_decode_split_states(
        q, k_pages, v_pages, lengths, block_tables, splits, k_scales,
        v_scales, step))
    return out.reshape(q.shape).to(q.dtype)
