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
``apr_matmul.cu`` and ``quant_matmul.cu`` compile (six each).
``apr_conv``, ``apr_conv_fused``, ``flash_decode``, ``flash_decode_paged``,
``mamba2`` and ``rwkv6`` have kernels compiled for one configuration, so
their spaces have one point (widening them is later performance work).

A shape of ``apr_matmul`` with ``"hbm": 1`` selects the memory-resident
baseline (``residency="hbm"``, shape key ``_reshbm``), as ``"kv_int8": 1``
selects the int8-pool variant of ``flash_decode_paged``.
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
from ..quant import quantize_channelwise
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


def _tile_space(tiles) -> TuneSpace:
    """The (block_m, block_n, block_k) tiles a matmul kernel compiles."""
    return TuneSpace.make(
        block_m=sorted({t[0] for t in tiles}),
        block_n=sorted({t[1] for t in tiles}),
        block_k=sorted({t[2] for t in tiles}),
        constraint=lambda cfg, s: (cfg["block_m"], cfg["block_n"],
                                   cfg["block_k"]) in tiles)


def _one_point(cfg):
    """The space of a kernel compiled for one configuration."""
    return TuneSpace.make(**{k: (v,) for k, v in cfg.to_dict().items()})


# ---------------------------------------------------------------- apr_matmul
def _residency(shape) -> str:
    return "hbm" if shape.get("hbm") else "apr"


def _matmul_inputs(shape, dtype, seed, device):
    gen = _gen(seed, device)
    return (_normal(gen, (shape["m"], shape["k"]), dtype, device),
            _normal(gen, (shape["k"], shape["n"]), dtype, device,
                    shape["k"] ** -0.5))


def _matmul_vmem(shape, cfg, dtype="float32"):
    return matmul_ops.smem_bytes(cfg["block_m"], cfg["block_n"],
                                 cfg["block_k"])


def _matmul_traffic(shape, cfg, dtype="float32"):
    m, k, n = shape["m"], shape["k"], shape["n"]
    isz = _itemsize(dtype)
    x_reads = m * k * isz * _cdiv(n, cfg["block_n"])
    y_reads = k * n * isz * _cdiv(m, cfg["block_m"])
    acc = reduction_hbm_traffic(m * n, _cdiv(k, cfg["block_k"]), _F32,
                                _residency(shape))
    return x_reads + y_reads + acc


def _apr_matmul_inputs(shape, dtype, seed, device):
    """The operands and the residency (``"hbm"`` for the baseline)."""
    return _matmul_inputs(shape, dtype, seed, device) + (_residency(shape),)


register(KernelSpec(
    name="apr_matmul",
    make_inputs=_apr_matmul_inputs,
    run=lambda args, cfg: matmul_ops.apr_matmul(
        args[0], args[1], config=cfg, residency=args[2]),
    ref=lambda args: matmul_ref(args[0], args[1]),
    tune_space=lambda shape: _tile_space(matmul_ops.TILES),
    default_config=lambda s: matmul_ops.default_config(s["m"], s["k"], s["n"]),
    shape_key=lambda s: matmul_ops.shape_key(s["m"], s["k"], s["n"],
                                             _residency(s)),
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
    """apr_matmul's streaming pattern at int8 width: both operands move 1
    byte/element plus their fp32 scales, whatever ``dtype`` the float
    activations had before quantization."""
    m, k, n = shape["m"], shape["k"], shape["n"]
    n_pass_x = _cdiv(n, cfg["block_n"])
    n_pass_y = _cdiv(m, cfg["block_m"])
    x_reads = (m * k * _I8 + m * _F32) * n_pass_x
    y_reads = (k * n * _I8 + n * _F32) * n_pass_y
    acc = reduction_hbm_traffic(m * n, _cdiv(k, cfg["block_k"]), _F32, "apr")
    return x_reads + y_reads + acc


def _qmm_vmem(shape, cfg, dtype="float32"):
    return qmm_ops.smem_bytes(cfg["block_m"], cfg["block_n"], cfg["block_k"])


register(KernelSpec(
    name="quant_matmul",
    make_inputs=_qmm_inputs,
    run=lambda args, cfg: qmm_ops.quant_matmul(*args, config=cfg),
    ref=lambda args: quant_matmul_ref(*args),
    tune_space=lambda shape: _tile_space(qmm_ops.TILES),
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
    tune_space=lambda shape: _tile_space(matmul_ops.TILES),
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
    tune_space=lambda shape: _tile_space(qmm_ops.TILES),
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


def _conv_traffic(shape, cfg, dtype="float32"):
    ho, wo = _conv_dims(shape)
    isz = _itemsize(dtype)
    mm = shape["b"] * ho * wo                       # im2col rows
    kk = shape["hf"] * shape["wf"] * shape["c"]     # im2col reduction depth
    nn = shape["m"]
    patches = mm * kk * isz * _cdiv(nn, cfg["block_n"])
    filters = kk * nn * isz * _cdiv(mm, cfg["block_m"])
    acc = reduction_hbm_traffic(mm * nn, _cdiv(kk, cfg["block_k"]), _F32,
                                "apr")
    return patches + filters + acc


def _conv_vmem(shape, cfg, dtype="float32"):
    """The fp32 patch and filter tiles of one K step plus the pixel tables
    (``conv_tile`` in apr_conv.cu)."""
    bp, bn, bk = cfg["block_m"], cfg["block_n"], cfg["block_k"]
    return 4 * (bk * (bp + 1) + bk * bn) + 3 * 4 * bp


def _conv_flops(s):
    ho, wo = _conv_dims(s)
    return 2 * s["b"] * ho * wo * s["hf"] * s["wf"] * s["c"] * s["m"]


def _conv_space(shape):
    return _one_point(conv_ops.compiled_config(shape["m"]))


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
    tune_space=lambda shape: _one_point(decode_ops.COMPILED),
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
    tune_space=lambda shape: _one_point(decode_ops.COMPILED),
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
    tune_space=lambda shape: _one_point(mamba_ops.COMPILED),
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
    tune_space=lambda shape: _one_point(rwkv_ops.COMPILED),
    default_config=lambda s: rwkv_ops.default_config(
        s["b"], s["t"], s["h"], s["d"]),
    shape_key=lambda s: rwkv_ops.shape_key(s["b"], s["t"], s["h"], s["d"]),
    flops=lambda s: 6 * s["b"] * s["t"] * s["h"] * s["d"] * s["d"],
    hbm_bytes=_rwkv_traffic,
    rtol=2e-3, atol=2e-3,
))
