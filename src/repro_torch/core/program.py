"""Loop-nest code generation for the three ISAs of the paper (Fig. 1).

The paper compiles the canonical 6-deep convolution loop nest with a
customised riscv-gnu-toolchain at -O0-like optimisation (the Fig. 1 assembly
re-computes every array address from stack-resident index variables each
iteration, which is why Table III shows ~100 dynamic instructions per MAC
for RV64F).  This module is that "compiler": it emits the same shape of
instruction stream for each ISA variant:

* ``RV64F``    (Fig. 1a): address(In)+flw, address(Fil)+flw, address(Out)+flw,
  ``fmul.s``, spill/reload of the product, ``fadd.s``, address(Out) again,
  ``fsw`` — the partial sum round-trips through memory every iteration.
* ``Baseline`` (Fig. 1b): same loads, single ``fmac.s``, and the output
  address is computed once (the inline-asm "+f" operand keeps it live).
* ``RV64R``    (Fig. 1c): address(In)+flw, address(Fil)+flw, ``rfmac.s`` —
  no output reference in the inner loop at all.  Once per output element,
  after the reduction loops close: address(Out), ``rfsmac.s``, ``fsw``.

Calibration knobs (``CodegenParams``) model -O0 stack-spill traffic and are
fitted ONCE against the (LeNet, RV64F) row of Table III, then held fixed for
every other (model, ISA) cell, so all *relative* enhancements are structural.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

from .isa import Instr, Isa, Kind


# ---------------------------------------------------------------------------
# Workload layer descriptions.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvLayer:
    """One convolution layer: M filters of C x Hf x Wf over an input plane,
    producing Ho x Wo output positions (stride folded into Ho/Wo)."""

    name: str
    M: int      # output channels / number of filters
    C: int      # input channels seen by each filter (1 for depthwise)
    Ho: int
    Wo: int
    Hf: int
    Wf: int
    Hin: int = 0
    Win: int = 0
    stride: int = 1

    @property
    def macs(self) -> int:
        return self.M * self.Ho * self.Wo * self.C * self.Hf * self.Wf

    @property
    def outputs(self) -> int:
        return self.M * self.Ho * self.Wo

    @property
    def input_bytes(self) -> int:
        hin = self.Hin or (self.Ho * self.stride + self.Hf - 1)
        win = self.Win or (self.Wo * self.stride + self.Wf - 1)
        return self.C * hin * win * 4

    @property
    def filter_bytes(self) -> int:
        return self.M * self.C * self.Hf * self.Wf * 4

    @property
    def output_bytes(self) -> int:
        return self.outputs * 4


@dataclass(frozen=True)
class FCLayer:
    """Fully-connected layer: O outputs, each a reduction over I inputs."""

    name: str
    O: int
    I: int

    @property
    def macs(self) -> int:
        return self.O * self.I

    @property
    def outputs(self) -> int:
        return self.O

    @property
    def input_bytes(self) -> int:
        return self.I * 4

    @property
    def filter_bytes(self) -> int:
        return self.O * self.I * 4

    @property
    def output_bytes(self) -> int:
        return self.O * 4


Layer = ConvLayer | FCLayer


# ---------------------------------------------------------------------------
# Codegen parameters (calibrated once on LeNet/RV64F — see calibration.py).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CodegenParams:
    spills_per_ref: int = 2   # sw+lw stack round-trips per array reference
    mv_per_ref: int = 2       # register-shuffle ALU ops per array reference
    extra_alu_per_mac: int = 0  # residual -O0 noise (sext.w etc.)
    schedule_loads: bool = True  # cluster index loads ahead of the address
                                 # arithmetic (matches Fig. 1 assembly layout)


# ---------------------------------------------------------------------------
# Instruction-sequence builders.
# ---------------------------------------------------------------------------


def _lw(dst: str, comment: str = "") -> Instr:
    return Instr(Kind.LOAD, dst=dst, srcs=("sp",), comment=comment)


def _sw(src: str, comment: str = "") -> Instr:
    return Instr(Kind.STORE, srcs=(src, "sp"), comment=comment)


def _alu(dst: str, *srcs: str, comment: str = "") -> Instr:
    return Instr(Kind.ALU, dst=dst, srcs=srcs, comment=comment)


def _mul(dst: str, *srcs: str) -> Instr:
    return Instr(Kind.MUL, dst=dst, srcs=srcs)


def gen_addr(
    tag: str,
    idx_dims: Sequence[str],
    compound: Sequence[bool],
    divided: Sequence[bool],
    params: CodegenParams,
) -> Tuple[List[Instr], str]:
    """-O0-style flattened address computation for a multi-dim array ref.

    ``idx_dims[q]`` names the q-th index variable; ``compound[q]`` marks an
    index of the form (a+b) (e.g. ``j+m``); ``divided[q]`` marks ``j/S``.
    Returns (instructions, address register name).
    """
    loads: List[Instr] = []
    arith: List[Instr] = []
    acc = f"{tag}_acc"
    for q, var in enumerate(idx_dims):
        v = f"{tag}_i{q}"
        loads.append(_lw(v, f"lw {var}"))
        if compound[q]:
            v2 = f"{tag}_i{q}b"
            loads.append(_lw(v2, f"lw {var}(+)"))
            arith.append(_alu(v, v, v2, comment="compound add"))
        if divided[q]:
            # -O0 keeps the stride S in a stack slot and emits a real div
            # (no strength reduction), serialising the address chain.
            s = f"{tag}_s{q}"
            loads.append(_lw(s, "lw S"))
            arith.append(Instr(Kind.DIV, dst=v, srcs=(v, s), comment="div /S"))
        if q == 0:
            arith.append(_alu(acc, v, comment="mv acc"))
        else:
            d = f"{tag}_d{q}"
            loads.append(_lw(d, "lw dim"))
            arith.append(_mul(acc, acc, d))
            arith.append(_alu(acc, acc, v))
    arith.append(_alu(f"{tag}_off", acc, comment="slli 2"))
    loads.append(_lw(f"{tag}_base", "lw base ptr"))
    addr = f"{tag}_addr"
    arith.append(_alu(addr, f"{tag}_base", f"{tag}_off"))
    if params.schedule_loads:
        out = loads + arith
    else:
        # naive interleave: each load placed immediately before its first use
        out = []
        pending = list(loads)
        for a in arith:
            for l in [p for p in pending if p.dst in a.srcs]:
                out.append(l)
                pending.remove(l)
            out.append(a)
        out = pending + out
    # -O0 spill/reload of the computed address through the stack; the reload
    # forwards from the store buffer, i.e. depends on the spilled value.
    for s in range(params.spills_per_ref):
        out.append(_sw(addr, "spill addr"))
        out.append(Instr(Kind.LOAD, dst=addr, srcs=(addr,), comment="reload addr"))
    for _ in range(params.mv_per_ref):
        out.append(_alu(addr, addr, comment="mv/sext"))
    return out, addr


def _ref_input_conv(params: CodegenParams) -> Tuple[List[Instr], str]:
    # Input[l][j+m][k+n]
    return gen_addr("in", ("l", "jm", "kn"), (False, True, True), (False,) * 3, params)


def _ref_filter_conv(params: CodegenParams) -> Tuple[List[Instr], str]:
    # Filter[i][l][m][n]
    return gen_addr("fil", ("i", "l", "m", "n"), (False,) * 4, (False,) * 4, params)


def _ref_output_conv(params: CodegenParams, tag: str = "out") -> Tuple[List[Instr], str]:
    # Output[i][j/S][k/S]
    return gen_addr(tag, ("i", "j", "k"), (False,) * 3, (False, True, True), params)


def _ref_input_fc(params: CodegenParams) -> Tuple[List[Instr], str]:
    return gen_addr("in", ("i",), (False,), (False,), params)


def _ref_filter_fc(params: CodegenParams) -> Tuple[List[Instr], str]:
    return gen_addr("fil", ("o", "i"), (False,) * 2, (False,) * 2, params)


def _ref_output_fc(params: CodegenParams, tag: str = "out") -> Tuple[List[Instr], str]:
    return gen_addr(tag, ("o",), (False,), (False,), params)


def mac_body(
    isa: Isa,
    params: CodegenParams,
    *,
    fc: bool = False,
) -> List[Instr]:
    """The innermost-loop body for one MAC under each ISA (paper Fig. 1)."""
    ref_in = _ref_input_fc if fc else _ref_input_conv
    ref_fil = _ref_filter_fc if fc else _ref_filter_conv
    ref_out = _ref_output_fc if fc else _ref_output_conv

    out: List[Instr] = []
    a_in_seq, a_in = ref_in(params)
    a_fil_seq, a_fil = ref_fil(params)
    out += a_in_seq
    out.append(Instr(Kind.FLW, dst="fa4", srcs=(a_in,), comment="flw input"))
    out += a_fil_seq
    out.append(Instr(Kind.FLW, dst="fa3", srcs=(a_fil,), comment="flw filter"))

    if isa == Isa.RV64F:
        a_out_seq, a_out = ref_out(params)
        out += a_out_seq
        out.append(Instr(Kind.FLW, dst="fa5", srcs=(a_out,), comment="flw partial"))
        out.append(Instr(Kind.FMUL, dst="ft0", srcs=("fa4", "fa3")))
        # -O0 spills the product through the stack before the add; the
        # reload store-to-load forwards, exposing the fmul latency.
        out.append(Instr(Kind.FSW, srcs=("ft0", "sp"), comment="spill product"))
        out.append(Instr(Kind.FLW, dst="ft0", srcs=("ft0",), comment="reload product"))
        out.append(Instr(Kind.FADD, dst="fa5", srcs=("fa5", "ft0")))
        a_out2_seq, a_out2 = ref_out(params, tag="out2")  # recomputed for the store
        out += a_out2_seq
        out.append(Instr(Kind.FSW, srcs=("fa5", a_out2), comment="fsw partial"))
    elif isa == Isa.BASELINE:
        a_out_seq, a_out = ref_out(params)
        out += a_out_seq
        out.append(Instr(Kind.FLW, dst="fa5", srcs=(a_out,), comment="flw partial"))
        out.append(Instr(Kind.FMAC, dst="fa5", srcs=("fa5", "fa4", "fa3")))
        out.append(Instr(Kind.FSW, srcs=("fa5", a_out), comment="fsw partial"))
    elif isa == Isa.RV64R:
        out.append(Instr(Kind.RFMAC, srcs=("fa4", "fa3"), comment="rfmac.s"))
    else:  # pragma: no cover
        raise ValueError(isa)

    for _ in range(params.extra_alu_per_mac):
        out.append(_alu("pad", "pad"))
    return out


def rfsmac_block(params: CodegenParams, *, fc: bool = False) -> List[Instr]:
    """Per-output-element epilogue for RV64R: rd <- APR, APR <- 0, store."""
    ref_out = _ref_output_fc if fc else _ref_output_conv
    seq, addr = ref_out(params, tag="outR")
    seq.append(Instr(Kind.RFSMAC, dst="fa5", comment="rfsmac.s"))
    seq.append(Instr(Kind.FSW, srcs=("fa5", addr), comment="fsw result"))
    return seq


def loop_overhead(level: str) -> Tuple[List[Instr], List[Instr]]:
    """-O0 per-iteration loop header (bound check) and footer (incr + jump)."""
    i = f"lv_{level}"
    header = [
        _lw(i, f"lw {level}"),
        _lw(f"{i}_b", f"lw bound({level})"),
        Instr(Kind.BRANCH, srcs=(i, f"{i}_b"), taken=False, comment=f"bge exit {level}"),
    ]
    footer = [
        _lw(i, f"lw {level}"),
        _alu(i, i, comment=f"addi {level}"),
        _sw(i, f"sw {level}"),
        Instr(Kind.JUMP, comment=f"j head {level}"),
    ]
    return header, footer


# ---------------------------------------------------------------------------
# Loop-nest IR + evaluation helpers.
# ---------------------------------------------------------------------------


@dataclass
class LoopNode:
    """One loop level.  Per iteration it runs: header, body, children (in
    order), post, footer."""

    level: str
    trips: int
    header: List[Instr] = field(default_factory=list)
    body: List[Instr] = field(default_factory=list)
    children: List["LoopNode"] = field(default_factory=list)
    post: List[Instr] = field(default_factory=list)
    footer: List[Instr] = field(default_factory=list)

    def own_stream(self) -> List[Instr]:
        return self.header + self.body + self.post + self.footer


def build_conv_nest(layer: ConvLayer, isa: Isa, params: CodegenParams) -> LoopNode:
    """Paper Fig. 1 loop order: i(M) j(Ho) k(Wo) l(C) m(Hf) n(Wf)."""
    levels = [
        ("i", layer.M),
        ("j", layer.Ho),
        ("k", layer.Wo),
        ("l", layer.C),
        ("m", layer.Hf),
        ("n", layer.Wf),
    ]
    inner_body = mac_body(isa, params, fc=False)
    node: Optional[LoopNode] = None
    for level, trips in reversed(levels):
        header, footer = loop_overhead(level)
        this = LoopNode(level=level, trips=trips, header=header, footer=footer)
        if node is None:
            this.body = inner_body
        else:
            this.children = [node]
        # RV64R: one rfsmac per output element, i.e. after the l-loop closes
        # inside the k-level iteration.
        if isa == Isa.RV64R and level == "k":
            this.post = rfsmac_block(params, fc=False)
        node = this
    assert node is not None
    return node


def build_fc_nest(layer: FCLayer, isa: Isa, params: CodegenParams) -> LoopNode:
    inner_body = mac_body(isa, params, fc=True)
    h_i, f_i = loop_overhead("i")
    inner = LoopNode(level="i", trips=layer.I, header=h_i, body=inner_body, footer=f_i)
    h_o, f_o = loop_overhead("o")
    outer = LoopNode(level="o", trips=layer.O, header=h_o, children=[inner], footer=f_o)
    if isa == Isa.RV64R:
        outer.post = rfsmac_block(params, fc=True)
    return outer


def build_nest(layer: Layer, isa: Isa, params: CodegenParams) -> LoopNode:
    if isinstance(layer, ConvLayer):
        return build_conv_nest(layer, isa, params)
    return build_fc_nest(layer, isa, params)
