"""Instruction-set definitions for the RISC-V R-extension reproduction.

Level-A (paper-faithful) model of the ISAs compared in the paper:

* ``RV64F``    — stock F-extension: ``fmul.s`` + ``fadd.s`` (+ ``flw``/``fsw``).
* ``BASELINE`` — RV64F plus a naive ``fmac.s`` MAC module in the EX stage
  (the paper's re-scalarised ``vmac``).
* ``RV64R``    — the paper's R-extension: ``rfmac.s`` (multiply in EX,
  accumulate into the APR in the rented R_EX stage) and ``rfsmac.s``
  (write APR to ``rd`` in ID, reset APR in MEM).

Encodings follow Fig. 3 / Fig. 4 of the paper exactly: OP-FP major opcode
(0b1010011), fmt=S (0b00), funct5 = FMUL 0x02 / FMAC 0x0C / RFMAC 0x0D /
RFSMAC 0x0E, with MASK/MATCH pairs that zero out the unused rd (rfmac.s)
and rs1/rs2 (rfsmac.s) fields.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# ISA variants under comparison (paper Table III rows).
# ---------------------------------------------------------------------------


class Isa(enum.Enum):
    RV64F = "rv64f"
    BASELINE = "baseline"  # RV64F + naive fmac.s in EX
    RV64R = "rv64r"        # rented-pipeline + APR

    @property
    def pretty(self) -> str:
        return {"rv64f": "RV64F", "baseline": "Baseline", "rv64r": "RV64R"}[self.value]


# ---------------------------------------------------------------------------
# Bit-level encodings (paper Fig. 3 / Fig. 4).
# ---------------------------------------------------------------------------

OPCODE_OP_FP = 0b1010011  # "OP-FP (0x14)" in the paper's 5-bit major-opcode
                          # notation; full 7-bit opcode incl. the 0b11 quadrant.

FMT_S = 0b00  # Table I: 32-bit single precision
FMT_D = 0b01
FMT_H = 0b10
FMT_Q = 0b11

FUNCT5_FMUL = 0x02
FUNCT5_FMAC = 0x0C
FUNCT5_RFMAC = 0x0D
FUNCT5_RFSMAC = 0x0E

RM_DYN = 0b111  # dynamic rounding mode (from CSR, per §II-B)


def _fp_encode(funct5: int, fmt: int, rs2: int, rs1: int, rm: int, rd: int) -> int:
    """Assemble a 32-bit OP-FP instruction word."""
    assert 0 <= funct5 < 32 and 0 <= fmt < 4
    assert 0 <= rs2 < 32 and 0 <= rs1 < 32 and 0 <= rd < 32 and 0 <= rm < 8
    return (
        (funct5 << 27)
        | (fmt << 25)
        | (rs2 << 20)
        | (rs1 << 15)
        | (rm << 12)
        | (rd << 7)
        | OPCODE_OP_FP
    )


def encode_fmul_s(rd: int, rs1: int, rs2: int, rm: int = RM_DYN) -> int:
    return _fp_encode(FUNCT5_FMUL, FMT_S, rs2, rs1, rm, rd)


def encode_fmac_s(rd: int, rs1: int, rs2: int, rm: int = RM_DYN) -> int:
    return _fp_encode(FUNCT5_FMAC, FMT_S, rs2, rs1, rm, rd)


def encode_rfmac_s(rs1: int, rs2: int, rm: int = RM_DYN) -> int:
    # rd field unused -> must be zero (enforced by MASK_RFMAC_S).
    return _fp_encode(FUNCT5_RFMAC, FMT_S, rs2, rs1, rm, rd=0)


def encode_rfsmac_s(rd: int, rm: int = RM_DYN) -> int:
    # rs1/rs2 unused -> must be zero (enforced by MASK_RFSMAC_S).
    return _fp_encode(FUNCT5_RFSMAC, FMT_S, 0, 0, rm, rd)


# MASK filters out the opcode + function fields; MATCH carries their values
# (paper Fig. 4).  Essential variable fields (rm, rs1, rs2, rd) are left open
# unless the instruction does not use them.
MASK_FMUL_S = 0xFE00007F
MATCH_FMUL_S = 0x10000053
MASK_FMAC_S = 0xFE00007F
MATCH_FMAC_S = 0x60000053
# rfmac.s writes no destination register: rd bits join the mask.
MASK_RFMAC_S = 0xFE000FFF
MATCH_RFMAC_S = 0x68000053
# rfsmac.s reads no source registers: rs1/rs2 bits join the mask.
MASK_RFSMAC_S = 0xFFF0007F | (0x1F << 15)  # funct5|fmt|rs2|rs1 masked
MATCH_RFSMAC_S = 0x70000053


def matches(word: int, mask: int, match: int) -> bool:
    return (word & mask) == match


def decode(word: int) -> str:
    """Decode a 32-bit word into one of the modelled OP-FP mnemonics."""
    for name, mask, match in (
        ("fmul.s", MASK_FMUL_S, MATCH_FMUL_S),
        ("fmac.s", MASK_FMAC_S, MATCH_FMAC_S),
        ("rfmac.s", MASK_RFMAC_S, MATCH_RFMAC_S),
        ("rfsmac.s", MASK_RFSMAC_S, MATCH_RFSMAC_S),
    ):
        if matches(word, mask, match):
            return name
    raise ValueError(f"unrecognised instruction word 0x{word:08x}")


# ---------------------------------------------------------------------------
# Micro-op level instruction model used by the trace generator + pipeline.
# ---------------------------------------------------------------------------


class Kind(enum.Enum):
    # integer
    ALU = "alu"          # add/sub/slli/srli/sext.w/li ...
    MUL = "mul"          # integer multiply (address arithmetic)
    DIV = "div"          # integer divide (j/S, k/S output indexing at -O0)
    LOAD = "load"        # lw/ld (integer load, incl. stack reloads)
    STORE = "store"      # sw/sd
    BRANCH = "branch"    # bge/bne/blt (conditional)
    JUMP = "jump"        # j / jal (always taken)
    # floating point
    FLW = "flw"
    FSW = "fsw"
    FMUL = "fmul.s"
    FADD = "fadd.s"
    FMAC = "fmac.s"      # baseline: naive MAC in EX
    RFMAC = "rfmac.s"    # R-ext: mul in EX, accumulate in rented R_EX via APR
    RFSMAC = "rfsmac.s"  # R-ext: rd <- APR (ID), APR <- 0 (MEM)
    NOP = "nop"

    @property
    def is_mem(self) -> bool:
        """Memory-type instruction (paper Table III column 5)."""
        return self in (Kind.LOAD, Kind.STORE, Kind.FLW, Kind.FSW)

    @property
    def is_load(self) -> bool:
        return self in (Kind.LOAD, Kind.FLW)

    @property
    def is_store(self) -> bool:
        return self in (Kind.STORE, Kind.FSW)

    @property
    def is_arith_fp(self) -> bool:
        return self in (Kind.FMUL, Kind.FADD, Kind.FMAC, Kind.RFMAC)


@dataclass(frozen=True)
class Instr:
    """One instruction in a trace.

    Register identities are symbolic strings so the generator can express
    dataflow without real register allocation; the pipeline model only cares
    about dependency structure.
    """

    kind: Kind
    dst: Optional[str] = None
    srcs: Tuple[str, ...] = ()
    taken: bool = False        # for BRANCH: statically taken this iteration?
    comment: str = ""

    @property
    def is_mem(self) -> bool:
        return self.kind.is_mem

    @property
    def reads_apr(self) -> bool:
        return self.kind in (Kind.RFMAC, Kind.RFSMAC)

    @property
    def writes_apr(self) -> bool:
        return self.kind in (Kind.RFMAC, Kind.RFSMAC)


def instr_allowed(kind: Kind, isa: Isa) -> bool:
    """Which instruction kinds exist under each ISA variant."""
    if kind == Kind.FMAC:
        return isa == Isa.BASELINE
    if kind in (Kind.RFMAC, Kind.RFSMAC):
        return isa == Isa.RV64R
    return True
