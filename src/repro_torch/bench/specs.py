"""KernelSpec registrations for the port's kernel families, under the JAX
package's names (``repro.bench.specs``): ``apr_matmul`` (with its
memory-resident baseline), ``apr_matmul_fused``, ``quant_matmul``,
``quant_matmul_fused``, ``apr_conv``, ``apr_conv_fused``, ``flash_decode``,
``flash_decode_paged`` (with its ``kv_int8`` variant), ``mamba2`` and
``rwkv6``.

Each spec wires a family's wrapper (``ops.py``), its plain version
(``ref.py``), the configurations its CUDA kernel is compiled for, and the
JAX package's analytic FLOP and memory-traffic models.  The JAX models
assume 4-byte operands; here the float operands' item size comes from the
``dtype`` argument, so at ``float32`` the models equal the JAX package's,
and at ``bfloat16`` they count what the card's kernels move.  The
``vmem_bytes`` models are the kernels' shared-memory footprints.

Tune spaces: the four matmul families list exactly the tiles
``apr_matmul.cu`` and ``quant_matmul.cu`` compile (six each; five for the
int8-weight kernel), each at the split counts their kernels take (at most
one per 128-row range of K, 256-row for the quant families; the
memory-resident baseline and the int8-weight kernel under bf16 operands
run one split).  Those two spaces depend on the operands' dtype: at
``float32`` they are the fp32 body's tiles (for an fp32 or an int8 weight,
and for the baseline at one split) at the same split counts.
``flash_decode`` and ``flash_decode_paged`` list the split counts their
kernels take (1, 2, 4, 8) at their one chunk.
``apr_conv`` and ``apr_conv_fused`` list the APR conv kernel's tiles (every
one gives the same bits), ``mamba2`` and ``rwkv6`` every configuration
their kernels compile.

A shape of ``apr_matmul`` with ``"hbm": 1`` selects the memory-resident
baseline (``residency="hbm"``, shape key ``_reshbm``), one with
``"w_int8": 1`` the int8-weight kernel (a :class:`QuantizedTensor` weight,
shape key ``_wint8``), as ``"kv_int8": 1`` selects the int8-pool variant
of ``flash_decode_paged``.
"""
from __future__ import annotations

import torch

from ..core.apr import reduction_hbm_traffic
from ..kernels.apr_conv import ops as conv_ops
from ..kernels.apr_conv.ref import conv2d_fused_ref, conv2d_ref
from ..kernels.apr_matmul import ops as matmul_ops
from ..kernels.apr_matmul.ref import matmul_fused_ref, matmul_ref
from ..kernels.flash_decode import ops as decode_ops
from ..kernels.flash_decode.ref import (decode_attention_ref,
                                        paged_decode_attention_q_ref,
                                        paged_decode_attention_ref)
from ..kernels.mamba2 import ops as mamba_ops
from ..kernels.mamba2.ref import mamba2_ref
from ..kernels.quant_matmul import ops as qmm_ops
from ..kernels.quant_matmul.ref import (quant_matmul_fused_ref,
                                        quant_matmul_ref)
from ..kernels.rwkv6 import ops as rwkv_ops
from ..kernels.rwkv6.ref import rwkv6_ref
from ..quant import QuantizedTensor, quantize_channelwise
from .config import shape_key_from_dims
from .registry import KernelSpec, TuneSpace, register

_F32 = 4  # fp32 outputs, scales and biases
_I8 = 1   # quantized operands stream 1 byte/element


def spec_verify_shapes(cfg, slots: int, spec_k: int):
    """Kernel shapes the speculative verify pass adds on top of the plain
    decode tick's: one batched ``decode_paged`` forward verifies ``spec_k``
    drafted tokens plus the pending token per slot, so the slot-batch GEMM
    widens from ``slots`` rows to ``slots * (spec_k + 1)``."""
    return [("apr_matmul", {"m": slots * (spec_k + 1), "k": cfg.d_model,
                            "n": cfg.d_ff})]


def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _normal(gen, shape, dtype, device, scale: float = 1.0):
    return (torch.randn(shape, generator=gen, device=device) * scale
            ).to(getattr(torch, dtype))


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile_space(tiles, splits=None) -> TuneSpace:
    """The (block_m, block_n, block_k) tiles a matmul kernel compiles, and
    with ``splits`` the split counts it takes at each."""
    extra = {} if splits is None else {"splits": splits}
    return TuneSpace.make(
        block_m=sorted({t[0] for t in tiles}),
        block_n=sorted({t[1] for t in tiles}),
        block_k=sorted({t[2] for t in tiles}),
        constraint=lambda cfg, s: (cfg["block_m"], cfg["block_n"],
                                   cfg["block_k"]) in tiles, **extra)


def _split_counts(shape) -> tuple:
    """The split counts swept at ``shape``: those that give every split a
    128-row range of K (one at least)."""
    ranges = max(1, _cdiv(shape["k"], matmul_ops.K_RANGE))
    return tuple(n for n in matmul_ops.SPLITS if n <= ranges)


def _among(compiled):
    """The space of a kernel compiled for the configurations in
    ``compiled``: exactly those."""
    keys = {k for cfg in compiled for k in cfg.to_dict()}
    return TuneSpace.make(
        constraint=lambda cfg, _: cfg in compiled,
        **{k: sorted({cfg[k] for cfg in compiled}) for k in keys})


# ---------------------------------------------------------------- apr_matmul
def _residency(shape) -> str:
    return "hbm" if shape.get("hbm") else "apr"


def _matmul_inputs(shape, dtype, seed, device):
    gen = _gen(seed, device)
    return (_normal(gen, (shape["m"], shape["k"]), dtype, device),
            _normal(gen, (shape["k"], shape["n"]), dtype, device,
                    shape["k"] ** -0.5))


def _matmul_vmem(shape, cfg, dtype="float32"):
    if dtype == "float32":
        smem = matmul_ops.f32_smem_bytes
    elif shape.get("w_int8"):
        smem = matmul_ops.int8w_smem_bytes
    elif (cfg["block_m"], cfg["block_n"], cfg["block_k"]) in \
            matmul_ops.WIDE_TILES:
        smem = matmul_ops.wide_smem_bytes
    else:
        smem = matmul_ops.smem_bytes
    return smem(cfg["block_m"], cfg["block_n"], cfg["block_k"])


def _matmul_traffic(shape, cfg, dtype="float32"):
    """The JAX package's model.  The int8-weight kernel (``w_int8``, the
    port's own) streams its weight at 1 byte per element plus the fp32
    column scales, and is modelled by the bytes it moves from device
    memory: the activations once (a few KB at the serving shapes, which
    every column block re-reads from the L2), not once per column block."""
    m, k, n = shape["m"], shape["k"], shape["n"]
    isz = _itemsize(dtype)
    if shape.get("w_int8"):
        x_reads = m * k * isz
        y_bytes = k * n * _I8 + n * _F32
    else:
        x_reads = m * k * isz * _cdiv(n, cfg["block_n"])
        y_bytes = k * n * isz
    y_reads = y_bytes * _cdiv(m, cfg["block_m"])
    acc = reduction_hbm_traffic(m * n, _cdiv(k, cfg["block_k"]), _F32,
                                _residency(shape))
    return x_reads + y_reads + acc


def _apr_matmul_inputs(shape, dtype, seed, device):
    """The operands and the residency (``"hbm"`` for the baseline); with
    ``w_int8`` the weight is its per-column int8 quantization."""
    x, y = _matmul_inputs(shape, dtype, seed, device)
    if shape.get("w_int8"):
        y = quantize_channelwise(y.float())
    return (x, y, _residency(shape))


def _apr_matmul_ref(args):
    x, y = args[0], args[1]
    if isinstance(y, QuantizedTensor):
        y = y.dequantize(x.dtype)
    return matmul_ref(x, y)


def _apr_matmul_default(s):
    if s.get("w_int8"):
        return matmul_ops.int8w_default_config(s["m"], s["k"], s["n"])
    return matmul_ops.default_config(s["m"], s["k"], s["n"], _residency(s))


def _bf16_tiles(shape) -> tuple:
    """The bf16 body's tiles swept at ``shape``: the wide ones too at
    ``m >= 128`` where TMA takes K and N (:func:`~matmul_ops.wide_takes`)."""
    if matmul_ops.wide_takes(shape["m"], shape["k"], shape["n"]):
        return matmul_ops.TILES + matmul_ops.WIDE_TILES
    return matmul_ops.TILES


def _apr_matmul_space(shape, dtype="bfloat16") -> TuneSpace:
    """bf16 operands: the bf16 tiles (wide ones at m >= 128) at each split
    count (the 16-row tiles at one split for the memory-resident
    baseline), or the int8-weight tiles; fp32 ``x``: the fp32 body's tiles
    at each split count (one for the baseline), over either weight."""
    if shape.get("hbm"):
        return _tile_space(matmul_ops.F32_TILES if dtype == "float32"
                           else matmul_ops.TILES, (1,))
    if dtype == "float32":
        return _tile_space(matmul_ops.F32_TILES, _split_counts(shape))
    if shape.get("w_int8"):
        return _tile_space(matmul_ops.INT8W_TILES)
    return _tile_space(_bf16_tiles(shape), _split_counts(shape))


def _fused_matmul_space(shape, dtype="bfloat16") -> TuneSpace:
    return _tile_space(matmul_ops.F32_TILES if dtype == "float32"
                       else _bf16_tiles(shape), _split_counts(shape))


register(KernelSpec(
    name="apr_matmul",
    make_inputs=_apr_matmul_inputs,
    run=lambda args, cfg: matmul_ops.apr_matmul(
        args[0], args[1], config=cfg, residency=args[2]),
    ref=_apr_matmul_ref,
    tune_space=_apr_matmul_space,
    dtype_space=True,
    default_config=_apr_matmul_default,
    shape_key=lambda s: matmul_ops.shape_key(s["m"], s["k"], s["n"],
                                             _residency(s),
                                             bool(s.get("w_int8"))),
    flops=lambda s: 2 * s["m"] * s["k"] * s["n"],
    hbm_bytes=_matmul_traffic,
    vmem_bytes=_matmul_vmem,
    rtol=5e-4, atol=5e-4,
))


# --------------------------------------------------------------- quant_matmul
def _qmm_inputs(shape, dtype, seed, device):
    """Activations stay float (``dtype``); the weight operand is quantized
    offline as ``repro_torch.quant.quantize_params`` stores it."""
    gen = _gen(seed, device)
    x = _normal(gen, (shape["m"], shape["k"]), dtype, device)
    w = _normal(gen, (shape["k"], shape["n"]), "float32", device)
    w_q, w_scale = qmm_ops.quantize_weights(w)
    return (x, w_q, w_scale)


def _qmm_traffic(shape, cfg, dtype="float32"):
    """apr_matmul's streaming pattern with an int8 weight: the kernel
    quantizes the activations inside its launch, so ``x`` moves at its
    float width (``dtype``), read once per column tile (its blocks find the
    rows' maxima and then stage the same rows, from the L2), and no int8
    ``x`` or activation scale is written or read; the weight moves 1
    byte/element plus its fp32 column scales, once per row tile."""
    m, k, n = shape["m"], shape["k"], shape["n"]
    n_pass_x = _cdiv(n, cfg["block_n"])
    n_pass_y = _cdiv(m, cfg["block_m"])
    x_reads = m * k * _itemsize(dtype) * n_pass_x
    y_reads = (k * n * _I8 + n * _F32) * n_pass_y
    acc = reduction_hbm_traffic(m * n, _cdiv(k, cfg["block_k"]), _F32, "apr")
    return x_reads + y_reads + acc


def _qmm_vmem(shape, cfg, dtype="float32"):
    return qmm_ops.smem_bytes(cfg["block_m"], cfg["block_n"], cfg["block_k"],
                              _itemsize(dtype))


def _qmm_space(shape) -> TuneSpace:
    """The compiled tiles at each split count that gives every split a
    256-row range of K (one at least).  The deepest K step is listed
    first: the cost model prices these candidates alike (bytes, not the
    per-step work), so a pruned sweep times the first ones, and the
    256-row step measured fastest at every llama3-8b projection shape on
    an H100 (PERF.md, PR 20)."""
    ranges = max(1, _cdiv(shape["k"], qmm_ops.K_RANGE))
    tiles = qmm_ops.TILES
    return TuneSpace.make(
        block_m=sorted({t[0] for t in tiles}),
        block_n=sorted({t[1] for t in tiles}),
        block_k=sorted({t[2] for t in tiles}, reverse=True),
        splits=tuple(n for n in qmm_ops.SPLITS if n <= ranges),
        constraint=lambda cfg, s: (cfg["block_m"], cfg["block_n"],
                                   cfg["block_k"]) in tiles)


register(KernelSpec(
    name="quant_matmul",
    make_inputs=_qmm_inputs,
    run=lambda args, cfg: qmm_ops.quant_matmul(*args, config=cfg),
    ref=lambda args: quant_matmul_ref(*args),
    tune_space=_qmm_space,
    default_config=lambda s: qmm_ops.default_config(s["m"], s["k"], s["n"]),
    shape_key=lambda s: qmm_ops.shape_key(s["m"], s["k"], s["n"]),
    flops=lambda s: 2 * s["m"] * s["k"] * s["n"],
    hbm_bytes=_qmm_traffic,
    vmem_bytes=_qmm_vmem,
    # the plain version repeats the kernel's integer arithmetic exactly;
    # only the fp32 scale multiplies could round differently
    rtol=1e-4, atol=1e-4,
))


# --------------------------------------------------------- fused epilogues
# Tuned under their own family names, as in the JAX package: the benchmark
# shape fixes the canonical epilogue (bias + relu); the wrappers take any
# activation at the same tiles.
def _fused_matmul_inputs(shape, dtype, seed, device):
    x, y = _matmul_inputs(shape, dtype, seed, device)
    return (x, y, _normal(_gen(seed + 1, device), (shape["n"],), "float32",
                          device))


register(KernelSpec(
    name="apr_matmul_fused",
    make_inputs=_fused_matmul_inputs,
    run=lambda args, cfg: matmul_ops.apr_matmul_fused(
        args[0], args[1], bias=args[2], activation="relu", config=cfg),
    ref=lambda args: matmul_fused_ref(args[0], args[1], args[2], "relu"),
    tune_space=_fused_matmul_space,
    dtype_space=True,
    default_config=lambda s: matmul_ops.default_config(s["m"], s["k"], s["n"]),
    shape_key=lambda s: shape_key_from_dims(m=s["m"], k=s["k"], n=s["n"]),
    flops=lambda s: 2 * s["m"] * s["k"] * s["n"] + 2 * s["m"] * s["n"],
    hbm_bytes=lambda s, cfg, dtype="float32": _matmul_traffic(s, cfg, dtype)
    + s["n"] * _F32 * _cdiv(s["m"], cfg["block_m"]),
    vmem_bytes=_matmul_vmem,
    rtol=5e-4, atol=5e-4,
))


def _fused_qmm_inputs(shape, dtype, seed, device):
    return _qmm_inputs(shape, dtype, seed, device) + (
        _normal(_gen(seed + 1, device), (shape["n"],), "float32", device),)


register(KernelSpec(
    name="quant_matmul_fused",
    make_inputs=_fused_qmm_inputs,
    run=lambda args, cfg: qmm_ops.quant_matmul_fused(
        args[0], args[1], args[2], bias=args[3], activation="relu",
        config=cfg),
    ref=lambda args: quant_matmul_fused_ref(args[0], args[1], args[2],
                                            args[3], "relu"),
    tune_space=_qmm_space,
    default_config=lambda s: qmm_ops.default_config(s["m"], s["k"], s["n"]),
    shape_key=lambda s: qmm_ops.shape_key(s["m"], s["k"], s["n"]),
    flops=lambda s: 2 * s["m"] * s["k"] * s["n"] + 2 * s["m"] * s["n"],
    hbm_bytes=lambda s, cfg, dtype="float32": _qmm_traffic(s, cfg, dtype)
    + s["n"] * _F32 * _cdiv(s["m"], cfg["block_m"]),
    vmem_bytes=_qmm_vmem,
    rtol=1e-4, atol=1e-4,
))


# ------------------------------------------------------------------ apr_conv
def _conv_dims(shape):
    ho = (shape["h"] + 2 * shape["padding"] - shape["hf"]) // shape["stride"] + 1
    wo = (shape["w"] + 2 * shape["padding"] - shape["wf"]) // shape["stride"] + 1
    return ho, wo


def _conv_geometry(s):
    return (s["b"], s["h"], s["w"], s["c"], s["hf"], s["wf"], s["m"],
            s["stride"], s["padding"])


def _conv_inputs(shape, dtype, seed, device):
    gen = _gen(seed, device)
    x = _normal(gen, (shape["b"], shape["h"], shape["w"], shape["c"]), dtype,
                device)
    f = _normal(gen, (shape["hf"], shape["wf"], shape["c"], shape["m"]),
                dtype, device)
    return (x, f, shape["stride"], shape["padding"])


def _conv_tile(cfg):
    """The APR kernel's tile that ``cfg`` names, or None (the baseline's
    tile, or any other configuration)."""
    d = cfg.to_dict()
    return next((t for t, c in zip(conv_ops.TILES, conv_ops.APR_CONFIGS)
                 if c.to_dict() == d), None)


def _conv_traffic(shape, cfg, dtype="float32"):
    """On an APR tile, what the kernel stages (``conv_ops.plan``): each
    tile's input halo with every channel (or, restaging, its pixels once
    a tap) for each channel slice, each tile's filter slice, and the output
    written once.  On
    any other configuration (the baseline's tile included) the JAX
    package's im2col model: the patch matrix once per column tile, the
    filter once per row tile."""
    ho, wo = _conv_dims(shape)
    isz = _itemsize(dtype)
    mm = shape["b"] * ho * wo                       # im2col rows
    kk = shape["hf"] * shape["wf"] * shape["c"]     # im2col reduction depth
    nn = shape["m"]
    out = reduction_hbm_traffic(mm * nn, 1, _F32, "apr")
    tile = _conv_tile(cfg)
    if tile is not None:
        p = conv_ops.plan(*_conv_geometry(shape), tile, isz)
        staged = (p["ti"] * p["hrows"] * p["hcols"] if p["resident"] else
                  shape["hf"] * shape["wf"] * p["ti"] * p["th"] * p["tw"])
        return (p["tiles"] * p["slices"] * staged * shape["c"] * isz
                + p["tiles"] * kk * nn * isz + out)
    patches = mm * kk * isz * _cdiv(nn, cfg["block_n"])
    filters = kk * nn * isz * _cdiv(mm, cfg["block_m"])
    acc = reduction_hbm_traffic(mm * nn, _cdiv(kk, cfg["block_k"]), _F32,
                                "apr")
    return patches + filters + acc


def _conv_vmem(shape, cfg, dtype="float32"):
    """On an APR tile, its shared memory: the ring of filter slots and the
    halo or the restaged pixels (``plan``'s ``smem``).  On any other
    configuration the baseline's fp32 patch and filter tiles of one K step
    plus its pixel tables."""
    tile = _conv_tile(cfg)
    if tile is not None:
        return conv_ops.plan(*_conv_geometry(shape), tile,
                             _itemsize(dtype))["smem"]
    bp, bn, bk = cfg["block_m"], cfg["block_n"], cfg["block_k"]
    return 4 * (bk * (bp + 1) + bk * bn) + 3 * 4 * bp


def _conv_flops(s):
    ho, wo = _conv_dims(s)
    return 2 * s["b"] * ho * wo * s["hf"] * s["wf"] * s["c"] * s["m"]


def _conv_space(shape):
    return _among(conv_ops.compiled_configs(shape["m"]))


register(KernelSpec(
    name="apr_conv",
    make_inputs=_conv_inputs,
    run=lambda args, cfg: conv_ops.apr_conv2d(
        args[0], args[1], stride=args[2], padding=args[3], config=cfg),
    ref=lambda args: conv2d_ref(args[0], args[1], stride=args[2],
                                padding=args[3]),
    tune_space=_conv_space,
    default_config=lambda s: conv_ops.default_config(*_conv_geometry(s)),
    shape_key=lambda s: conv_ops.shape_key(*_conv_geometry(s)),
    flops=_conv_flops,
    hbm_bytes=_conv_traffic,
    vmem_bytes=_conv_vmem,
    rtol=2e-3, atol=2e-3,
))


def _fused_conv_inputs(shape, dtype, seed, device):
    x, f, stride, padding = _conv_inputs(shape, dtype, seed, device)
    bias = _normal(_gen(seed + 1, device), (shape["m"],), "float32", device)
    return (x, f, bias, stride, padding)


def _fused_conv_traffic(shape, cfg, dtype="float32"):
    # the conv's streams plus the (1, M) bias read once per output-tile row
    ho, wo = _conv_dims(shape)
    mm = shape["b"] * ho * wo
    return (_conv_traffic(shape, cfg, dtype)
            + shape["m"] * _F32 * _cdiv(mm, cfg["block_m"]))


register(KernelSpec(
    name="apr_conv_fused",
    make_inputs=_fused_conv_inputs,
    run=lambda args, cfg: conv_ops.apr_conv2d_fused(
        args[0], args[1], bias=args[2], activation="relu",
        stride=args[3], padding=args[4], config=cfg),
    ref=lambda args: conv2d_fused_ref(args[0], args[1], args[2], "relu",
                                      stride=args[3], padding=args[4]),
    tune_space=_conv_space,
    default_config=lambda s: conv_ops.default_config(*_conv_geometry(s)),
    shape_key=lambda s: conv_ops.fused_shape_key(*_conv_geometry(s)),
    flops=_conv_flops,
    hbm_bytes=_fused_conv_traffic,
    vmem_bytes=_conv_vmem,
    rtol=2e-3, atol=2e-3,
))


# -------------------------------------------------------------- flash_decode
def _decode_inputs(shape, dtype, seed, device):
    gen = _gen(seed, device)
    b, hq, hkv, d, s = (shape["b"], shape["hq"], shape["hkv"], shape["d"],
                        shape["s"])
    q = _normal(gen, (b, hq, d), dtype, device)
    k = _normal(gen, (b, s, hkv, d), dtype, device)
    v = _normal(gen, (b, s, hkv, d), dtype, device)
    lengths = torch.full((b,), s, dtype=torch.int32, device=device)
    return (q, k, v, lengths)


def _decode_traffic(shape, cfg, dtype="float32"):
    b, hq, hkv, d, s = (shape["b"], shape["hq"], shape["hkv"], shape["d"],
                        shape["s"])
    isz = _itemsize(dtype)
    streams = (2 * b * s * hkv * d + 2 * b * hq * d) * isz  # K,V in; Q,O
    acc = reduction_hbm_traffic(b * hq * d, _cdiv(s, cfg["chunk"]), isz,
                                "apr")
    return streams + acc


register(KernelSpec(
    name="flash_decode",
    make_inputs=_decode_inputs,
    run=lambda args, cfg: decode_ops.flash_decode(*args, config=cfg),
    ref=lambda args: decode_attention_ref(*args),
    tune_space=lambda shape: TuneSpace.make(
        chunk=(decode_ops.COMPILED["chunk"],), splits=decode_ops.SPLITS),
    default_config=lambda s: decode_ops.default_config(
        s["b"], s["hq"], s["hkv"], s["d"], s["s"]),
    shape_key=lambda s: decode_ops.shape_key(
        s["b"], s["hq"], s["hkv"], s["d"], s["s"]),
    flops=lambda s: 4 * s["b"] * s["hq"] * s["s"] * s["d"],  # QK^T + PV
    hbm_bytes=_decode_traffic,
    rtol=2e-3, atol=2e-3,
))


# ------------------------------------------------------- flash_decode_paged
def _paged_decode_inputs(shape, dtype, seed, device):
    """Pages are assigned out of order (striped across the pool), so the
    block-table gather is exercised; with ``kv_int8`` the pools are
    quantized per (token, head) as the serve engine stores them."""
    gen = _gen(seed, device)
    b, hq, hkv, d = shape["b"], shape["hq"], shape["hkv"], shape["d"]
    pages, ps = shape["pages"], shape["ps"]
    pool = b * pages + 1                      # + reserved null page 0
    q = _normal(gen, (b, hq, d), dtype, device)
    k_pages = _normal(gen, (pool, ps, hkv, d), dtype, device)
    v_pages = _normal(gen, (pool, ps, hkv, d), dtype, device)
    # slot i's j-th logical page -> physical page 1 + j*b + i
    bt = (1 + torch.arange(pages, device=device)[None, :] * b
          + torch.arange(b, device=device)[:, None]).to(torch.int32)
    lengths = torch.full((b,), pages * ps, dtype=torch.int32, device=device)
    if shape.get("kv_int8"):
        kq = quantize_channelwise(k_pages, axis=-1)
        vq = quantize_channelwise(v_pages, axis=-1)
        return (q, kq.q, vq.q, kq.scale[..., 0].contiguous(),
                vq.scale[..., 0].contiguous(), lengths, bt)
    return (q, k_pages, v_pages, lengths, bt)


def _paged_decode_run(args, cfg):
    if len(args) == 7:                        # int8 pools + scale pools
        q, kp, vp, ks, vs, lengths, bt = args
        return decode_ops.flash_decode_paged(
            q, kp, vp, lengths, bt, k_scales=ks, v_scales=vs, config=cfg)
    return decode_ops.flash_decode_paged(*args, config=cfg)


def _paged_decode_ref(args):
    if len(args) == 7:
        return paged_decode_attention_q_ref(*args)
    return paged_decode_attention_ref(*args)


def _paged_decode_traffic(shape, cfg, dtype="float32"):
    b, hq, hkv, d = shape["b"], shape["hq"], shape["hkv"], shape["d"]
    isz = _itemsize(dtype)
    s = shape["pages"] * shape["ps"]          # live logical tokens per seq
    if shape.get("kv_int8"):                  # int8 payload + fp32 head scale
        kv_bytes = 2 * b * s * hkv * (d * _I8 + _F32)
    else:
        kv_bytes = 2 * b * s * hkv * d * isz
    streams = kv_bytes + 2 * b * hq * d * isz            # K,V in; Q,O
    acc = reduction_hbm_traffic(b * hq * d, _cdiv(s, cfg["chunk"]), isz,
                                "apr")
    return streams + acc


register(KernelSpec(
    name="flash_decode_paged",
    make_inputs=_paged_decode_inputs,
    run=_paged_decode_run,
    ref=_paged_decode_ref,
    tune_space=lambda shape: TuneSpace.make(
        chunk=(decode_ops.COMPILED["chunk"],), splits=decode_ops.SPLITS),
    default_config=lambda s: decode_ops.paged_default_config(
        s["b"], s["hq"], s["hkv"], s["d"], s["pages"], s["ps"]),
    shape_key=lambda s: decode_ops.paged_shape_key(
        s["b"], s["hq"], s["hkv"], s["d"], s["pages"], s["ps"],
        bool(s.get("kv_int8"))),
    flops=lambda s: 4 * s["b"] * s["hq"] * s["pages"] * s["ps"] * s["d"],
    hbm_bytes=_paged_decode_traffic,
    rtol=2e-3, atol=2e-3,
))


# -------------------------------------------------------------------- mamba2
def _mamba_inputs(shape, dtype, seed, device):
    gen = _gen(seed, device)
    b, t, h, p, n = (shape["b"], shape["t"], shape["h"], shape["p"],
                     shape["n"])
    x = _normal(gen, (b, t, h, p), dtype, device)
    bmat = _normal(gen, (b, t, n), dtype, device)
    cmat = _normal(gen, (b, t, n), dtype, device)
    dt = _uniform(gen, (b, t, h), 1e-3, 0.1, device)
    a = -_uniform(gen, (h,), 0.5, 1.5, device)
    d = _normal(gen, (h,), "float32", device)
    return (x, bmat, cmat, dt, a, d)


def _mamba_traffic(shape, cfg, dtype="float32"):
    b, t, h, p, n = (shape["b"], shape["t"], shape["h"], shape["p"],
                     shape["n"])
    isz = _itemsize(dtype)
    # x/y and the B/C streams broadcast per head in ``dtype``, dt in fp32;
    # the (P, N) state is the APR
    streams = (2 * b * t * h * p + 2 * b * t * h * n) * isz + b * t * h * _F32
    acc = reduction_hbm_traffic(b * h * p * n, _cdiv(t, cfg["chunk"]), _F32,
                                "apr")
    return streams + acc


register(KernelSpec(
    name="mamba2",
    make_inputs=_mamba_inputs,
    run=lambda args, cfg: mamba_ops.mamba2_ssd(*args, config=cfg),
    ref=lambda args: mamba2_ref(*args),
    tune_space=lambda shape: _among(mamba_ops.compiled_configs()),
    default_config=lambda s: mamba_ops.default_config(
        s["b"], s["t"], s["h"], s["p"], s["n"]),
    shape_key=lambda s: mamba_ops.shape_key(
        s["b"], s["t"], s["h"], s["p"], s["n"]),
    flops=lambda s: 6 * s["b"] * s["t"] * s["h"] * s["p"] * s["n"],
    hbm_bytes=_mamba_traffic,
    rtol=2e-3, atol=2e-3,
))


# --------------------------------------------------------------------- rwkv6
def _rwkv_inputs(shape, dtype, seed, device):
    """The decay ``w`` stays fp32 (the kernel takes it so: it reaches far
    below bf16's resolution near 1); ``u`` is in ``dtype`` with r/k/v."""
    gen = _gen(seed, device)
    b, t, h, d = shape["b"], shape["t"], shape["h"], shape["d"]
    r = _normal(gen, (b, t, h, d), dtype, device)
    k = _normal(gen, (b, t, h, d), dtype, device)
    v = _normal(gen, (b, t, h, d), dtype, device)
    w = _uniform(gen, (b, t, h, d), 0.3, 0.99, device)
    u = _normal(gen, (h, d), dtype, device)
    return (r, k, v, w, u)


def _rwkv_traffic(shape, cfg, dtype="float32"):
    b, t, h, d = shape["b"], shape["t"], shape["h"], shape["d"]
    isz = _itemsize(dtype)
    streams = 4 * b * t * h * d * isz + b * t * h * d * _F32  # r/k/v/y, w
    acc = reduction_hbm_traffic(b * h * d * d, _cdiv(t, cfg["chunk"]), _F32,
                                "apr")
    return streams + acc


register(KernelSpec(
    name="rwkv6",
    make_inputs=_rwkv_inputs,
    run=lambda args, cfg: rwkv_ops.rwkv6_wkv(*args, config=cfg),
    ref=lambda args: rwkv6_ref(*args),
    tune_space=lambda shape: _among(rwkv_ops.compiled_configs()),
    default_config=lambda s: rwkv_ops.default_config(
        s["b"], s["t"], s["h"], s["d"]),
    shape_key=lambda s: rwkv_ops.shape_key(s["b"], s["t"], s["h"], s["d"]),
    flops=lambda s: 6 * s["b"] * s["t"] * s["h"] * s["d"] * s["d"],
    hbm_bytes=_rwkv_traffic,
    rtol=2e-3, atol=2e-3,
))
