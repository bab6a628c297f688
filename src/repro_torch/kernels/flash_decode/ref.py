"""Plain PyTorch versions of decode attention (mirror of the JAX
``ref.py``).  The contiguous :func:`decode_attention_ref` is the JAX oracle
as it is: a row with ``lengths == 0`` returns the mean of V over all S
positions, as the JAX contiguous kernel does.  The paged versions differ
from the JAX oracle in one deliberate place: rows with ``lengths == 0``
return zeros, as the paged kernels (JAX's and the port's) do."""
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


def _attend(q, k, v, lengths, zero_dead: bool):
    """fp32 masked softmax attention of one query token, rounded once to
    ``q.dtype``.  Query head ``h`` reads kv head ``h // G``.  Positions at
    or past ``lengths`` score -1e30; with ``zero_dead`` they also get weight
    exactly 0 (and the sum is divided by ``max(l, 1e-30)``), so a row of
    length 0 is zero; without it such a row weighs every position alike."""
    b, hq, d = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    kt = k.permute(0, 2, 1, 3).float()                  # (B,Hkv,S,D)
    vt = v.permute(0, 2, 1, 3).float()
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, kt) / (d ** 0.5)
    live = (torch.arange(s, device=q.device)[None, None, None, :]
            < lengths.to(q.device)[:, None, None, None])
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


def paged_decode_attention_ref(q, k_pages, v_pages, lengths, block_tables):
    """q: (B,Hq,D); k/v_pages: (P_pool,ps,Hkv,D); lengths: (B,);
    block_tables: (B,P_max) -> (B,Hq,D).  Gather-then-attend version of the
    paged kernel: positions past ``lengths`` (incl. anything routed through
    the null page) are masked before the softmax; a row of length 0 is
    zero."""
    return _attend(q, gather_pages(k_pages, block_tables),
                   gather_pages(v_pages, block_tables), lengths,
                   zero_dead=True)


def paged_decode_attention_q_ref(q, k_pages, v_pages, k_scales, v_scales,
                                 lengths, block_tables):
    """int8-KV version: dequantize the gathered pages (per-(page slot,
    head) fp32 scales over the head dim), round them to ``q.dtype`` as the
    JAX oracle does, then attend as :func:`paged_decode_attention_ref`.
    (The kernel keeps the dequantized values in fp32.)"""
    k = (gather_pages(k_pages, block_tables).float()
         * gather_pages(k_scales, block_tables)[..., None])
    v = (gather_pages(v_pages, block_tables).float()
         * gather_pages(v_scales, block_tables)[..., None])
    return _attend(q, k.to(q.dtype), v.to(q.dtype), lengths, zero_dead=True)
