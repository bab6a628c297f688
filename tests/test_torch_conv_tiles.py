"""The APR conv kernel's tiles (``csrc/apr_conv.cu``), on the CPU: a numpy
model of the kernel's index map, built from the tile constants of the
source, shows for every conv geometry that ``chip_smoke.py``'s phase 2 runs
(LeNet-5 and ResNet-20 at batch 1 and 256, and the ragged list) that each
output is owned by exactly one thread of each compiled tile, that the halo
(or the restaged pixels) a block stages is what its outputs read, with
zeros only where the conv pads, that each output's chain walks the im2col
column order, and that each tile's shared memory fits and equals what the
tune spec reports.  Then the wrappers' ``block_*`` pins resolve as the JAX
package's, and the CPU wrappers under each pin match the JAX Pallas conv in
interpret mode.  The kernel itself is held to the plain version, bit for
bit across its tiles, on the card by ``chip_smoke.py``."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bench.config import resolve_config as jax_resolve_config
from repro.kernels.apr_conv import apr_conv2d as jax_apr_conv2d
from repro.kernels.apr_conv import apr_conv2d_fused as jax_apr_conv2d_fused
from repro.kernels.apr_conv import ops as jax_conv_ops
from repro_torch.bench import TileError, get_spec
from repro_torch.bench.config import pin_config, shape_key_from_dims
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels.apr_conv import (apr_conv2d, apr_conv2d_fused,
                                          im2col)
from repro_torch.kernels.apr_conv import ops as conv_ops
from repro_torch.models.cnn import CNNS, conv_geometries

SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
       / "apr_conv.cu").read_text()
#: the JAX conv tests' tolerance (tests/test_kernels_conv.py)
TOL = dict(rtol=2e-4, atol=2e-4)

#: phase 2's ragged geometries (chip_smoke.conv_correctness), as
#: (B, H, W, C, Hf, Wf, M, stride, pad)
RAGGED = [(1, 32, 32, 1, 5, 5, 6, 1, 0), (1, 14, 14, 6, 5, 5, 16, 1, 0),
          (1, 16, 16, 16, 3, 3, 32, 2, 1), (1, 8, 8, 64, 1, 1, 64, 1, 0),
          (2, 10, 10, 8, 3, 3, 12, 1, 1), (3, 9, 11, 1, 3, 3, 5, 2, 1),
          (2, 15, 13, 3, 3, 3, 10, 2, 1), (2, 7, 7, 24, 3, 3, 40, 1, 1),
          (1, 9, 9, 8, 3, 3, 70, 1, 0), (1, 4, 4, 8, 3, 3, 16, 1, 0),
          (4, 17, 17, 5, 5, 5, 33, 3, 2), (1, 3, 300, 128, 3, 3, 8, 1, 1),
          (2, 5, 5, 132, 3, 3, 20, 1, 1), (1, 8, 8, 4, 3, 3, 8, 1, 1),
          (2, 32, 32, 3, 3, 3, 16, 1, 1), (2, 15, 13, 16, 3, 3, 32, 2, 1)]


def _geometries():
    seen = {}
    for net in CNNS:
        for batch in (1, 256):
            for g in conv_geometries(net, batch):
                (b, h, w, c), (hf, wf, _, m) = g["x_shape"], g["f_shape"]
                seen[(b, h, w, c, hf, wf, m, g["stride"], g["padding"])] = 0
    for g in RAGGED:
        seen[g] = 0
    return list(seen)


GEOMETRIES = _geometries()


def _source_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _source_tiles() -> tuple:
    body = re.search(r"#define APR_CONV_TILES\(X\)(.*?)\n\n", SRC,
                     re.S).group(1)
    return tuple(tuple(int(v) for v in m.groups()) for m in re.finditer(
        r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)", body))


TILES = _source_tiles()
STEP_CHANNELS = _source_int("STEP_CHANNELS")
RING = _source_int("RING")
WHOLE_BYTES = _source_int("WHOLE_BYTES")
SMEM_MAX = _source_int("SMEM_MAX")


def _odd_groups(c: int) -> int:
    """An odd number of 4-element groups covering ``c``: the staged pixel
    stride, so that 4-wide loads of neighbouring pixels hit distinct
    banks."""
    return 4 * (-(-c // 4) | 1)


class Model:
    """The kernel's launch on one geometry and tile, from the source's
    constants: the block's output tile, what it stages, and which thread
    owns which output."""

    def __init__(self, geom, tile, itemsize=4):
        (self.B, self.H, self.W, self.C, self.Hf, self.Wf, self.M, self.s,
         self.p) = geom
        self.BN, self.TN, self.TP, self.NT, _ = tile
        self.TXN = self.BN // self.TN
        self.TYP = self.NT // self.TXN
        self.BP = self.TYP * self.TP
        self.Ho = (self.H + 2 * self.p - self.Hf) // self.s + 1
        self.Wo = (self.W + 2 * self.p - self.Wf) // self.s + 1
        self.tw = min(self.Wo, self.BP)
        self.th = min(self.Ho, self.BP // self.tw)
        self.ti = min(self.B, self.BP // (self.tw * self.th))
        self.tiles = (-(-self.Wo // self.tw), -(-self.Ho // self.th),
                      -(-self.B // self.ti))
        self.slices = -(-self.M // self.BN)
        self.c4 = -(-self.C // 4) * 4
        self.hrows = (self.th - 1) * self.s + self.Hf
        self.hcols = (self.tw - 1) * self.s + self.Wf
        self.npx = self.ti * self.th * self.tw
        fc = min(self.c4, STEP_CHANNELS)
        self.cs = _odd_groups(self.c4)
        staged = self.ti * self.hrows * self.hcols * self.cs
        steps = self.Hf * self.Wf * -(-self.c4 // fc)
        # a filter slice this small is staged whole, else a ring of RING
        ring = steps if steps * fc * self.BN * itemsize <= WHOLE_BYTES \
            else RING
        # the halo, where it fits and the stride does not pass the filter
        self.resident = (ring * fc * self.BN + staged) * itemsize <= \
            SMEM_MAX and self.s <= min(self.Hf, self.Wf)
        if not self.resident:
            ring = RING
        while not self.resident:
            self.cs = _odd_groups(fc)
            staged = self.npx * self.cs
            if (ring * fc * self.BN + staged) * itemsize <= SMEM_MAX or \
                    fc == 4:
                break
            fc -= 4
        self.fc, self.staged, self.ring = fc, staged, ring
        self.smem = (ring * fc * self.BN + staged) * itemsize
        self.nch = -(-self.c4 // fc)

    def pixels(self):
        """(block x, ty, i) -> (b, ho, wo) of the thread's i-th pixel, the
        pixel's index q in the block's tile, and whether it is stored."""
        tw_n, th_n, _ = self.tiles
        bx = np.arange(np.prod(self.tiles))[:, None, None]
        q = (np.arange(self.TYP)[None, :, None]
             + np.arange(self.TP)[None, None, :] * self.TYP)
        qi, qr = q // (self.th * self.tw), q % (self.th * self.tw)
        qh, qw = qr // self.tw, qr % self.tw
        b = bx // (tw_n * th_n) * self.ti + qi
        ho = bx // tw_n % th_n * self.th + qh
        wo = bx % tw_n * self.tw + qw
        ok = (q < self.npx) & (b < self.B) & (ho < self.Ho) & (wo < self.Wo)
        return np.broadcast_arrays(b, ho, wo, q, ok)

    def channels(self):
        """(block y, tx, j4, e) -> output channel, and whether stored."""
        n = (np.arange(self.slices)[:, None, None, None] * self.BN
             + (np.arange(self.TN // 4)[None, None, :, None] * self.TXN
                + np.arange(self.TXN)[None, :, None, None]) * 4
             + np.arange(4)[None, None, None, :])
        return n, n < self.M

    def read(self, b, ho, wo, q, di, dj):
        """The input (b, ih, iw) the kernel reads at tap (di, dj) for each
        pixel, and whether the staged element is a zero fill; the staged
        element's cell must lie inside the staged buffer."""
        qi = q // (self.th * self.tw)
        b0 = b - qi
        if self.resident:
            qr = q % (self.th * self.tw)
            qh, qw = qr // self.tw, qr % self.tw
            cell = ((qi * self.hrows + qh * self.s + di) * self.hcols
                    + qw * self.s + dj)
            rr, col = cell // self.hcols, cell % self.hcols
            assert (col == qw * self.s + dj).all()      # no row wrap
            ho0 = ho - qh
            ib = b0 + rr // self.hrows
            ih = ho0 * self.s - self.p + rr % self.hrows
            iw = (wo - qw) * self.s - self.p + col
            assert (cell < self.ti * self.hrows * self.hcols).all()
        else:
            cell = q
            ib = b0 + cell // (self.th * self.tw)
            ih = ho * self.s - self.p + di
            iw = wo * self.s - self.p + dj
            assert (cell < self.npx).all()
        assert ((cell + 1) * self.cs <= self.staged).all()
        zero = (ib >= self.B) | (ih < 0) | (ih >= self.H) | (iw < 0) | \
            (iw >= self.W)
        return ib, ih, iw, zero

    def chain(self):
        """Each step's (tap, channels) in the order the kernel walks them."""
        steps = []
        for s in range(self.Hf * self.Wf * self.nch):
            tap, c0 = s // self.nch, s % self.nch * self.fc
            steps.append((tap, range(c0, c0 + min(self.fc, self.c4 - c0))))
        return steps


def test_source_tiles_are_the_wrappers():
    """The wrapper's tiles, step depth and shared-memory cap are the
    source's, and its default rule is the source's (the first tile whose
    M bound covers M, which ``apr_conv`` without a tile runs)."""
    assert TILES == conv_ops.TILES
    assert STEP_CHANNELS == conv_ops.STEP_CHANNELS
    assert (RING, WHOLE_BYTES) == (conv_ops.RING, conv_ops.WHOLE_BYTES)
    assert SMEM_MAX == conv_ops.SMEM_MAX <= 227 * 1024
    assert "if (m <= MMAX) return index;" in SRC
    for m in range(1, 140):
        want = next(i for i, t in enumerate(TILES) if m <= t[4])
        assert conv_ops.default_tile(m) == want
        assert TILES[want][0] >= min(m, 64)      # one slice where M <= 64


@pytest.mark.parametrize("tile", TILES, ids=lambda t: "x".join(map(str, t)))
def test_every_output_has_one_owner(tile):
    for geom in GEOMETRIES:
        m = Model(geom, tile)
        b, ho, wo, _, ok = m.pixels()
        flat = ((b * m.Ho + ho) * m.Wo + wo)[ok]
        assert (np.bincount(flat, minlength=m.B * m.Ho * m.Wo) == 1).all(), \
            geom
        n, nok = m.channels()
        assert (np.bincount(n[nok], minlength=m.M) == 1).all(), geom
        assert m.tiles[0] * m.tiles[1] * m.tiles[2] < 2 ** 31
        assert m.slices <= 65535


@pytest.mark.parametrize("tile", TILES, ids=lambda t: "x".join(map(str, t)))
def test_staged_input_is_what_the_outputs_read(tile):
    """Every tap of every stored output reads the staged element of the
    input pixel the conv reads there, and a zero exactly where the conv
    pads; the restaging path is taken only where the halo does not fit."""
    for geom in GEOMETRIES:
        m = Model(geom, tile)
        b, ho, wo, q, ok = m.pixels()
        b, ho, wo, q = b[ok], ho[ok], wo[ok], q[ok]
        for di in range(m.Hf):
            for dj in range(m.Wf):
                ib, ih, iw, zero = m.read(b, ho, wo, q, di, dj)
                want_h, want_w = ho * m.s - m.p + di, wo * m.s - m.p + dj
                assert (ib == b).all() and (ih == want_h).all() and \
                    (iw == want_w).all(), (geom, di, dj)
                pad = (want_h < 0) | (want_h >= m.H) | (want_w < 0) | \
                    (want_w >= m.W)
                assert (zero == pad).all(), (geom, di, dj)


def test_restaging_path_covers_the_wide_rows():
    """A halo 258 pixels wide with 128 channels (three rows of a 300-wide
    input) does not fit, so the steps restage; C = 132 walks three channel
    ranges a tap."""
    wide = Model((1, 3, 300, 128, 3, 3, 8, 1, 1), TILES[0])
    assert not wide.resident and wide.smem <= SMEM_MAX
    deep = Model((2, 5, 5, 132, 3, 3, 20, 1, 1), TILES[0])
    assert deep.resident and deep.nch == 3 and deep.fc == STEP_CHANNELS
    # a 1x1 conv at stride 2 restages: its halo would be 3/4 unread pixels
    short = Model((2, 32, 32, 16, 1, 1, 32, 2, 0), TILES[1])
    assert not short.resident and short.fc == 16 and short.nch == 1


@pytest.mark.parametrize("geom", [(2, 7, 7, 6, 3, 3, 8, 1, 1),
                                  (1, 9, 11, 3, 5, 5, 4, 2, 2),
                                  (2, 5, 5, 132, 3, 3, 20, 1, 1),
                                  (1, 3, 300, 128, 3, 3, 8, 1, 1)])
def test_chain_walks_the_im2col_columns(geom):
    """The values an output's chain multiplies, step by step (a pad
    channel's zero product left out), are its im2col row in column order,
    on every tile: k = (di·Wf + dj)·C + c ascending."""
    rng = np.random.default_rng(0)
    x = rng.permutation(np.prod(geom[:4])).reshape(geom[:4]) + 1.0
    cols, _, _ = im2col(torch.from_numpy(x), geom[4], geom[5], geom[7],
                        geom[8])
    for tile in TILES:
        m = Model(geom, tile)
        b, ho, wo, q, ok = m.pixels()
        b, ho, wo, q = b[ok], ho[ok], wo[ok], q[ok]
        seq = []
        for tap, chans in m.chain():
            ib, ih, iw, zero = m.read(b, ho, wo, q, tap // m.Wf, tap % m.Wf)
            for c in chans:
                if c >= m.C:
                    continue                # fmaf(0, 0, acc): acc
                v = x[ib.clip(0, m.B - 1), ih.clip(0, m.H - 1),
                      iw.clip(0, m.W - 1), c]
                seq.append(np.where(zero, 0.0, v))
        rows = (b * m.Ho + ho) * m.Wo + wo
        np.testing.assert_array_equal(np.stack(seq, 1),
                                      cols.numpy()[rows], str(tile))


@pytest.mark.parametrize("dtype,itemsize", [("float32", 4),
                                            ("bfloat16", 2)])
def test_shared_memory_fits_and_is_the_specs(dtype, itemsize):
    for name in ("apr_conv", "apr_conv_fused"):
        spec = get_spec(name)
        for geom in GEOMETRIES:
            shape = dict(zip(("b", "h", "w", "c", "hf", "wf", "m", "stride",
                              "padding"), geom))
            for tile, cfg in zip(TILES, conv_ops.APR_CONFIGS):
                m = Model(geom, tile, itemsize)
                assert m.smem <= SMEM_MAX, (geom, tile)
                assert spec.vmem_bytes(shape, cfg, dtype) == m.smem
                p = conv_ops.plan(*geom, tile, itemsize)
                assert (p["resident"], p["fc"], p["cs"], p["nch"], p["ring"],
                        p["smem"]) == (m.resident, m.fc, m.cs, m.nch, m.ring,
                                       m.smem)
                assert (p["ti"], p["th"], p["tw"]) == (m.ti, m.th, m.tw)


# ------------------------------------------------------ pins and wrappers
DIMS = (2, 7, 7, 8, 3, 3, 12, 1, 1)


def _keys(residency):
    b, h, w, c, hf, wf, m, s, p = DIMS
    if residency is None:
        return "apr_conv_fused", shape_key_from_dims(
            b=b, h=h, w=w, c=c, hf=hf, wf=wf, m=m, s=s, p=p)
    return "apr_conv", jax_conv_ops.shape_key(*DIMS, residency)


@pytest.mark.parametrize("residency", ["apr", "hbm", None])
def test_pins_resolve_as_jax(residency, tmp_path, monkeypatch):
    """Every compiled tile of a key, pinned whole, resolves to what the
    JAX package's ``resolve_config(explicit=)`` gives for the same pins;
    a tile the kernel of that key is not compiled for raises TileError."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    kernel, key = _keys(residency)
    x, f = torch.zeros(DIMS[:4]), torch.zeros((3, 3, 8, 12))
    compiled = conv_ops.compiled_configs(12, residency or "apr")
    assert conv_ops.default_config(*DIMS, residency or "apr") in compiled
    for cfg in compiled:
        pins = cfg.to_dict()
        want = jax_resolve_config(kernel, key, "float32", "cuda",
                                  default=jax_conv_ops.default_config(*DIMS),
                                  explicit=pins)
        got = conv_ops.resolve_launch(kernel, x, f, 1, 1, residency,
                                      pin_config(None, **pins))
        assert got.to_dict() == want.to_dict() == pins
    other = conv_ops.compiled_configs(12, "apr" if residency == "hbm"
                                      else "hbm")
    for cfg in list(other) + [conv_ops.tile_config((16, 4, 4, 128, 0))]:
        with pytest.raises(TileError):
            conv_ops.resolve_launch(kernel, x, f, 1, 1, residency,
                                    pin_config(None, **cfg.to_dict()))


def _case(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(DIMS[:4]).astype(np.float32)
    f = rng.standard_normal((3, 3, 8, 12)).astype(np.float32)
    return (jnp.asarray(x), jnp.asarray(f)), (tensor_from_numpy(x),
                                              tensor_from_numpy(f))


@pytest.mark.parametrize("residency", ["apr", "hbm"])
def test_cpu_wrapper_under_each_pin_matches_jax_kernel(residency, tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    (xj, fj), (xt, ft) = _case(0)
    for cfg in sorted(conv_ops.compiled_configs(12, residency)):
        pins = cfg.to_dict()
        ref = jax_apr_conv2d(xj, fj, padding=1, residency=residency,
                             interpret=True, **pins)
        got = apr_conv2d(xt, ft, padding=1, residency=residency, **pins)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_cpu_fused_wrapper_under_each_pin_matches_jax_kernel(tmp_path,
                                                             monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    (xj, fj), (xt, ft) = _case(1)
    bias = np.random.default_rng(2).standard_normal(12).astype(np.float32)
    for cfg in sorted(conv_ops.compiled_configs(12)):
        pins = cfg.to_dict()
        ref = jax_apr_conv2d_fused(xj, fj, jnp.asarray(bias),
                                   activation="relu", padding=1,
                                   interpret=True, **pins)
        got = apr_conv2d_fused(xt, ft, torch.from_numpy(bias),
                               activation="relu", padding=1, **pins)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
