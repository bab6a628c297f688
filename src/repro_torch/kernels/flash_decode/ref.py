"""Plain PyTorch versions of paged decode attention (mirror of the JAX
``ref.py``, with one deliberate difference: rows with ``lengths == 0``
return zeros, as the paged kernel does, where the JAX oracle averages the
masked values)."""
import torch

NEG_INF = -1e30


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Materialise the logical contiguous view of a paged KV pool.

    pages: (P_pool, page_size, H, D); block_tables: (B, P_max) int ->
    (B, P_max * page_size, H, D).  Row ``b``'s logical token ``t`` lives at
    ``pages[block_tables[b, t // page_size], t % page_size]``.
    """
    b, p_max = block_tables.shape
    g = pages[block_tables.reshape(-1).long()]
    return g.reshape(b, p_max * pages.shape[1], *pages.shape[2:])


def decode_attention_ref(q, k, v, lengths):
    """q: (B,Hq,D); k/v: (B,S,Hkv,D); lengths: (B,) -> (B,Hq,D).

    fp32 throughout, rounded once to ``q.dtype``.  Query head ``h`` reads kv
    head ``h // G`` (G = Hq/Hkv).  Lanes at or past ``lengths`` get weight
    exactly 0 and the sum is divided by ``max(l, 1e-30)``, so a row of
    length 0 is zero."""
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
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bhsd->bhgd", p, vt) / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, d).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, lengths, block_tables):
    """q: (B,Hq,D); k/v_pages: (P_pool,ps,Hkv,D); lengths: (B,);
    block_tables: (B,P_max) -> (B,Hq,D).  Gather-then-attend version of the
    paged kernel: positions past ``lengths`` (incl. anything routed through
    the null page) are masked before the softmax."""
    return decode_attention_ref(q, gather_pages(k_pages, block_tables),
                                gather_pages(v_pages, block_tables), lengths)
