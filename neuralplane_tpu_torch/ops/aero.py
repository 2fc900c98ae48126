"""Aero-coefficient names, the weight containers of the three aero backends
and the coefficient query (counterpart of neuralplane_tpu/ops/aero.py and the
loader of ops/aero_pallas.py:467-521).

Backends (`select_aero_weights`): "stacked" is the 43-net ensemble as plain
float32 tensor ops on any device (`AeroWeights`); "pallas" is the same 43
nets inside the fused CUDA kernels of `ops/aero_grouped_cuda.py` and
`ops/step_cuda.py` (`GroupedAeroWeights`; the name is kept from the JAX
package, where those kernels are Pallas kernels); "distilled" is the
consolidated single-trunk surrogate (`DistilledAeroWeights`); "auto" is
"distilled".
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

from ..surrogates import distill

# Canonical coefficient order (neuralplane_tpu/ops/aero.py AERO_NAMES).
AERO_NAMES = (
    "Cx", "Cz", "Cm", "Cy", "Cn", "Cl",
    "Cxq", "Cyr", "Cyp", "Czq", "Clr", "Clp", "Cmq", "Cnr", "Cnp",
    "delta_Cx_lef", "delta_Cz_lef", "delta_Cm_lef", "delta_Cy_lef",
    "delta_Cn_lef", "delta_Cl_lef",
    "delta_Cxq_lef", "delta_Cyr_lef", "delta_Cyp_lef", "delta_Czq_lef",
    "delta_Clr_lef", "delta_Clp_lef", "delta_Cmq_lef", "delta_Cnr_lef",
    "delta_Cnp_lef",
    "delta_Cy_r30", "delta_Cn_r30", "delta_Cl_r30",
    "delta_Cy_a20", "delta_Cy_a20_lef", "delta_Cn_a20", "delta_Cn_a20_lef",
    "delta_Cl_a20", "delta_Cl_a20_lef",
    "delta_Cnbeta", "delta_Clbeta", "delta_Cm", "eta_el",
)
IDX = {name: i for i, name in enumerate(AERO_NAMES)}
K = len(AERO_NAMES)
OUT = 64      # readout rows of the container (43 real, zero-padded)
F_PAD = 80    # the kernels' feature width: 68 features padded to 5 x 16
KERNEL_HIDDEN = 256  # the hidden width the CUDA kernels are built for (csrc/distilled.cuh)
OUT_N = 48    # readout rows in the kernels' weight image: 43 padded to 6 x 8
# Byte offsets of the distilled kernels' weight image (csrc/distilled.cuh
# IMG_*): the three weight matrices as tensor-core B operands, then the
# float32 vectors.
IMG_W1 = 0
IMG_W2 = IMG_W1 + KERNEL_HIDDEN * F_PAD * 2
IMG_W3 = IMG_W2 + KERNEL_HIDDEN * KERNEL_HIDDEN * 2
IMG_B3 = IMG_W3 + OUT_N * (KERNEL_HIDDEN + F_PAD) * 2
IMG_SD = IMG_B3 + OUT_N * 4
IMG_MU = IMG_SD + OUT_N * 4
IMG_B1 = IMG_MU + OUT_N * 4
IMG_B2 = IMG_B1 + KERNEL_HIDDEN * 4
IMG_B1H = IMG_B2 + KERNEL_HIDDEN * 4   # b1, b2 rounded to bf16
IMG_B2H = IMG_B1H + KERNEL_HIDDEN * 2
IMG_BYTES = IMG_B2H + KERNEL_HIDDEN * 2

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
_DISTILLED_NPZ = os.path.join(_DATA, "f16_aero_distilled.npz")
_AERO_NPZ = os.path.join(_DATA, "f16_aero.npz")
LEAVES = ("W1", "b1", "W2", "b2", "W3", "b3", "out_mean", "out_std")
AERO_LEAVES = ("W1", "b1", "W2", "b2", "W3", "b3", "W4", "b4")
BACKENDS = ("auto", "distilled", "pallas", "stacked")
# Widths of one of the 43 nets: 3 -> 20 -> 20 -> 10 -> 1.
N_IN, N_H1, N_H2, N_H3 = 3, 20, 20, 10
# The grouped kernels' padded widths (csrc/grouped.cuh): K of each product
# in 8s, N in 8s.
KP1, NP1, NP2, NP3 = 8, 24, 24, 16
FRAG_WORDS = 20      # 32-bit words of B fragments per lane and net
BIAS_PAIRS = 8       # column pairs a lane adds a bias to: 3 + 3 + 2 tiles
NET_WORDS = FRAG_WORDS * 32 + 4 * BIAS_PAIRS   # int32 words per net in `frags`
VEC_BIAS = 4 * 2 * BIAS_PAIRS                  # float32 biases per net, [4 t][16]
VEC_FLOATS = VEC_BIAS + 4                      # then b4, padded to a multiple of 4


@dataclasses.dataclass(eq=False)
class DistilledAeroWeights:
    """Distilled-trunk weights, left-multiply convention (y = W @ x).

    W1 [H, F], W2 [H, H], W3 [OUT, H + F] are bf16; b1, b2 [H], b3, out_mean,
    out_std [OUT] are float32. W3 reads [hidden ; hinge features]."""
    W1: torch.Tensor
    b1: torch.Tensor
    W2: torch.Tensor
    b2: torch.Tensor
    W3: torch.Tensor
    b3: torch.Tensor
    out_mean: torch.Tensor
    out_std: torch.Tensor

    def __post_init__(self):
        self._packed = None

    @property
    def hidden(self) -> int:
        return self.W1.shape[0]

    @property
    def device(self) -> torch.device:
        return self.W1.device

    def leaves(self):
        return tuple(getattr(self, k) for k in LEAVES)

    def to_numpy(self):
        """float32 numpy leaves in LEAVES order (inverse of distilled_from_numpy)."""
        return tuple(t.detach().float().cpu().numpy() for t in self.leaves())

    def packed(self) -> torch.Tensor:
        """The kernels' weight image, made once per container: uint8
        [IMG_BYTES], byte for byte what a block keeps in shared memory
        (csrc/distilled.cuh). W1 zero-padded to [H, F_PAD], W2 [H, H] and the
        first OUT_N rows of W3 zero-padded to [OUT_N, H + F_PAD], each as
        `core_matrix_image`; then the first OUT_N of b3, out_std, out_mean
        and b1, b2 [H] in float32; then b1, b2 rounded to bf16, which is
        what the hidden_bf16 mode adds."""
        if self._packed is None:
            H, F = self.W1.shape
            if H != KERNEL_HIDDEN or F != distill.N_FEAT:
                raise ValueError(f"the CUDA kernels are built for H = {KERNEL_HIDDEN}, "
                                 f"F = {distill.N_FEAT}; got H={H}, F={F}")
            bf = torch.bfloat16
            w1p = torch.zeros(H, F_PAD, dtype=bf)
            w1p[:, :F] = self.W1.detach().cpu()
            w3p = torch.zeros(OUT_N, H + F_PAD, dtype=bf)
            w3p[:, :H + F] = self.W3.detach().cpu()[:OUT_N]
            parts = [core_matrix_image(w) for w in (w1p, self.W2.detach().cpu(), w3p)]
            parts += [v.detach().cpu().contiguous().view(torch.uint8)
                      for v in (self.b3[:OUT_N], self.out_std[:OUT_N],
                                self.out_mean[:OUT_N], self.b1, self.b2,
                                self.b1.to(bf), self.b2.to(bf))]
            image = torch.cat(parts)
            assert image.numel() == IMG_BYTES
            self._packed = image.to(self.device)
        return self._packed


def core_matrix_image(W: torch.Tensor) -> torch.Tensor:
    """W [N, K] (bf16, N and K multiples of 8) as the B operand of Hopper's
    warpgroup MMA reads it from shared memory without swizzle
    (csrc/wgmma.cuh): cut into core matrices of 8 rows x 8 columns, each 128
    contiguous bytes (row n % 8 at byte 16 (n % 8)), ordered k block major:
    element (n, k) sits at byte 16 N (k // 8) + 128 (n // 8) + 16 (n % 8) +
    2 (k % 8). Returns uint8 [2 N K]."""
    N, K = W.shape
    tiles = W.contiguous().reshape(N // 8, 8, K // 8, 8).permute(2, 0, 1, 3)
    return tiles.contiguous().view(torch.uint8).reshape(-1)


def distilled_from_numpy(leaves: Sequence[np.ndarray],
                         device="cuda") -> DistilledAeroWeights:
    """Carry the JAX package's DistilledAeroWeightsT leaves (as numpy, in
    LEAVES order; W1/W2/W3 arrive as bf16 and are cast to float32 first)
    into the port's container on `device`."""
    if len(leaves) != len(LEAVES):
        raise ValueError(f"expected {len(LEAVES)} leaves {LEAVES}, got {len(leaves)}")
    t = {}
    for name, a in zip(LEAVES, leaves):
        a = torch.from_numpy(np.asarray(a).astype(np.float32))
        t[name] = a.to(device=device,
                       dtype=torch.bfloat16 if name[0] == "W" else torch.float32)
    if t["W3"].shape[0] != OUT:
        raise ValueError(f"W3 must have {OUT} rows, got {t['W3'].shape[0]}")
    return DistilledAeroWeights(**t)


def load_distilled(path: str | None = None, device="cuda") -> DistilledAeroWeights:
    """Load the shipped distilled npz (the port's copy of the JAX package's
    data file), checking coefficient order, knots and input scaling as
    ops/aero_pallas.py:_load_distilled_np does."""
    path = path or _DISTILLED_NPZ
    with np.load(path) as z:
        names = tuple(str(n) for n in z["names"])
        if names != AERO_NAMES:
            raise ValueError(f"{path}: coefficient order mismatch")
        for key, ref in (("alpha_knots", distill.ALPHA_KNOTS),
                         ("beta_knots", distill.BETA_KNOTS),
                         ("el_knots", distill.EL_KNOTS),
                         ("in_scale", distill.IN_SCALE),
                         ("in_mean", distill.IN_MEAN)):
            if not np.allclose(z[key], ref):
                raise ValueError(f"{path}: {key} mismatch - re-run distillation")
        leaves = [z[k] for k in LEAVES]
    return distilled_from_numpy(leaves, device=device)


@dataclasses.dataclass(eq=False)
class AeroWeights:
    """The 43-net ensemble, stacked: every leaf is float32 and leads with
    the net axis K = 43 (neuralplane_tpu/ops/aero.py:AeroWeights). One net is
    y = relu(relu(relu(x W1 + b1) W2 + b2) W3 + b3) . W4 + b4 on raw
    (alpha_deg, beta_deg, el_deg). This container selects the plain stacked
    query (`aero_backend="stacked"`)."""
    W1: torch.Tensor  # [K, 3, 20]
    b1: torch.Tensor  # [K, 20]
    W2: torch.Tensor  # [K, 20, 20]
    b2: torch.Tensor  # [K, 20]
    W3: torch.Tensor  # [K, 20, 10]
    b3: torch.Tensor  # [K, 10]
    W4: torch.Tensor  # [K, 10]
    b4: torch.Tensor  # [K]

    @property
    def device(self) -> torch.device:
        return self.W1.device

    def leaves(self):
        return tuple(getattr(self, k) for k in AERO_LEAVES)

    def to_numpy(self):
        """float32 numpy leaves in AERO_LEAVES order (inverse of aero_from_numpy)."""
        return tuple(t.detach().cpu().numpy() for t in self.leaves())


def _fragment_words(B: torch.Tensor, k0: int, j: int, halves: int):
    """B-operand fragment words of mma.sync.m16n8k16 (halves = 2) or
    m16n8k8 (halves = 1) for rows k0.. of B [K, rows, cols] (bf16), column
    tile j: lane 4g + t holds (B[k0 + 2t + 8h][8j + g], B[k0 + 2t + 1 + 8h]
    [8j + g]) as the low and high half of word h. Returns `halves` int32
    tensors [K, 32]."""
    lane = torch.arange(32)
    g, t = lane >> 2, lane & 3
    words = []
    for h in range(halves):
        r = k0 + 2 * t + 8 * h
        pair = torch.stack([B[:, r, 8 * j + g], B[:, r + 1, 8 * j + g]], dim=-1)
        words.append(pair.contiguous().view(torch.int32)[..., 0])
    return words


@dataclasses.dataclass(eq=False)
class GroupedAeroWeights(AeroWeights):
    """The same 43 nets for the fused CUDA kernels (`aero_backend="pallas"`;
    counterpart of GroupedAeroWeightsT). The leaves stay the stacked float32
    ones; `packed()` is the kernels' layout, and the plain versions round
    the leaves to bf16 where the kernels do."""

    def __post_init__(self):
        self._packed = None

    def packed(self):
        """(frags, vec), made once per container (csrc/grouped.cuh reads
        them). One net is one chain of tensor-core products with K padded
        3 -> 8 and 20 -> 16 + 8, N padded 20 -> 24 and 10 -> 16, and the
        readout one more product whose B operand holds W4 (K padded
        10 -> 16) in each of its eight columns.
        frags int32 [K, NET_WORDS]: per net first [10, 32, 2], per lane 20
        words of bf16 B fragments - the m16n8k8 ones (W1 tiles 0-2, rows
        16-23 of W2 tiles 0-2 and of W3 tiles 0-1), then the m16n8k16 ones
        (rows 0-15 of W2 tiles 0-2, of W3 tiles 0-1, W4), two words each -
        stored as 10 pairs so that a warp reads one pair per lane from
        consecutive addresses; then [4, 8]: for t = lane % 4 the biases
        rounded to bf16 of the column pairs (8 j + 2 t, 8 j + 2 t + 1) that
        a lane holds, as bf16x2 words in the order b1 j = 0-2, b2 j = 0-2,
        b3 j = 0-1 (two 16-byte loads).
        vec float32 [K, VEC_FLOATS]: [4, 16] the same pairs in float32
        (four 16-byte loads), then b4, zero padded."""
        if self._packed is None:
            bf = torch.bfloat16
            k = self.W1.shape[0]
            cpu = [t.detach().float().cpu() for t in self.leaves()]
            W1, b1, W2, b2, W3, b3, W4, b4 = cpu
            B1 = torch.zeros(k, KP1, NP1, dtype=bf)
            B1[:, :N_IN, :N_H1] = W1.to(bf)
            B2 = torch.zeros(k, NP1, NP2, dtype=bf)
            B2[:, :N_H1, :N_H2] = W2.to(bf)
            B3 = torch.zeros(k, NP2, NP3, dtype=bf)
            B3[:, :N_H2, :N_H3] = W3.to(bf)
            B4 = torch.zeros(k, NP3, 8, dtype=bf)
            B4[:, :N_H3, :] = W4.to(bf)[:, :, None]
            words = []
            for j in range(NP1 // 8):
                words += _fragment_words(B1, 0, j, 1)
            for j in range(NP2 // 8):
                words += _fragment_words(B2, 16, j, 1)
            for j in range(NP3 // 8):
                words += _fragment_words(B3, 16, j, 1)
            for j in range(NP2 // 8):
                words += _fragment_words(B2, 0, j, 2)
            for j in range(NP3 // 8):
                words += _fragment_words(B3, 0, j, 2)
            words += _fragment_words(B4, 0, 0, 2)
            assert len(words) == FRAG_WORDS
            frags = torch.stack(words, dim=1).reshape(k, FRAG_WORDS // 2, 2, 32)
            frags = frags.permute(0, 1, 3, 2).reshape(k, FRAG_WORDS * 32)
            # the biases a lane adds, by t: columns 8 j + 2 t, + 1 of each tile
            padded = [torch.zeros(k, n) for n in (NP1, NP2, NP3)]
            for dst, b in zip(padded, (b1, b2, b3)):
                dst[:, :b.shape[1]] = b
            pairs = torch.cat([p.reshape(k, -1, 4, 2) for p in padded], dim=1)  # [K, 8, t, 2]
            pairs = pairs.permute(0, 2, 1, 3).contiguous()                       # [K, t, 8, 2]
            bias_words = pairs.to(bf).view(torch.int32).reshape(k, 4 * BIAS_PAIRS)
            vec = torch.zeros(k, VEC_FLOATS)
            vec[:, :VEC_BIAS] = pairs.reshape(k, VEC_BIAS)
            vec[:, VEC_BIAS] = b4
            frags = torch.cat([frags, bias_words], dim=1).contiguous()
            assert frags.shape == (k, NET_WORDS)
            self._packed = (frags.to(self.device), vec.to(self.device))
        return self._packed


def aero_from_numpy(leaves: Sequence[np.ndarray], device="cuda") -> AeroWeights:
    """Carry the JAX package's AeroWeights leaves (as numpy, in AERO_LEAVES
    order) into the port's stacked container on `device`."""
    if len(leaves) != len(AERO_LEAVES):
        raise ValueError(f"expected {len(AERO_LEAVES)} leaves {AERO_LEAVES}, "
                         f"got {len(leaves)}")
    t = {name: torch.from_numpy(np.asarray(a).astype(np.float32)).to(device)
         for name, a in zip(AERO_LEAVES, leaves)}
    k = t["W1"].shape[0]
    want = {"W1": (k, N_IN, N_H1), "b1": (k, N_H1), "W2": (k, N_H1, N_H2),
            "b2": (k, N_H2), "W3": (k, N_H2, N_H3), "b3": (k, N_H3),
            "W4": (k, N_H3), "b4": (k,)}
    for name, shape in want.items():
        if tuple(t[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t[name].shape)}")
    return AeroWeights(**t)


def pack_grouped(w: AeroWeights) -> GroupedAeroWeights:
    """The stacked container as the fused kernels' one (counterpart of
    ops/aero_pallas.py:pack_grouped_t); the leaves are shared."""
    return GroupedAeroWeights(*w.leaves())


def load_aero_weights(path: str | None = None, device="cuda") -> AeroWeights:
    """Load the shipped 43-net npz (the port's copy of the JAX package's
    data file), checking the coefficient order as ops/aero.py:_load_np does."""
    path = path or _AERO_NPZ
    with np.load(path) as z:
        names = tuple(str(n) for n in z["names"])
        if names != AERO_NAMES:
            raise ValueError(f"{path}: coefficient order mismatch - regenerate")
        leaves = [z[k] for k in AERO_LEAVES]
    return aero_from_numpy(leaves, device=device)


def select_aero_weights(backend: str = "auto", device="cuda"):
    """The weight container of an aero backend on `device`: "stacked" ->
    AeroWeights (plain float32 tensor ops, any device), "pallas" ->
    GroupedAeroWeights (the 43 nets in the fused CUDA kernels),
    "distilled" or "auto" -> DistilledAeroWeights. The environment variable
    NEURALPLANE_AERO_BACKEND overrides `backend`, as in the JAX package."""
    backend = os.environ.get("NEURALPLANE_AERO_BACKEND", backend)
    if backend not in BACKENDS:
        raise ValueError(f"aero_backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "stacked":
        return load_aero_weights(device=device)
    if backend == "pallas":
        return pack_grouped(load_aero_weights(device=device))
    return load_distilled(device=device)


def aero_coeffs_stacked(w: AeroWeights, alpha_deg, beta_deg, el_deg) -> torch.Tensor:
    """The float32 stacked query (ops/aero.py:120-130): [n] x 3 -> [n, K]."""
    k = w.W1.shape[0]
    x = torch.stack([alpha_deg, beta_deg, el_deg], dim=-1)             # [n, 3]
    n = x.shape[0]
    h = torch.relu(x @ w.W1.permute(1, 0, 2).reshape(N_IN, k * N_H1)
                   + w.b1.reshape(k * N_H1)).reshape(n, k, N_H1)
    h = torch.relu(torch.einsum("nki,kij->nkj", h, w.W2) + w.b2)     # [n, K, 20]
    h = torch.relu(torch.einsum("nki,kij->nkj", h, w.W3) + w.b3)     # [n, K, 10]
    return torch.einsum("nki,ki->nk", h, w.W4) + w.b4                  # [n, K]


def aero_coeffs_t(w, alpha_deg, beta_deg, el_deg) -> torch.Tensor:
    """All 43 coefficients, coefficient-major: [K, n] rows in AERO_NAMES
    order (ops/aero.py:aero_coeffs_t). Dispatches on the container: the
    fused kernel for GroupedAeroWeights, the float32 stacked query for
    AeroWeights, the quantized trunk for DistilledAeroWeights."""
    if isinstance(w, GroupedAeroWeights):
        from .aero_grouped_cuda import aero_coeffs_grouped
        return aero_coeffs_grouped(w, alpha_deg, beta_deg, el_deg)
    if isinstance(w, AeroWeights):
        return aero_coeffs_stacked(w, alpha_deg, beta_deg, el_deg).T
    if isinstance(w, DistilledAeroWeights):
        p = distill.DistilledParams(
            W1=w.W1.float(), b1=w.b1, W2=w.W2.float(), b2=w.b2,
            W3=w.W3[:K].float(), b3=w.b3[:K])
        return distill.quantized_coeffs(p, w.out_mean[:K], w.out_std[:K],
                                        alpha_deg, beta_deg, el_deg)
    raise TypeError(f"aero_coeffs_t got {type(w).__name__}")


def aero_coeffs(w, alpha_deg, beta_deg, el_deg) -> torch.Tensor:
    """All 43 coefficients, [n, K] with columns in AERO_NAMES order
    (ops/aero.py:aero_coeffs); same dispatch as aero_coeffs_t, the fused
    kernel writing its rows in this layout itself."""
    if isinstance(w, GroupedAeroWeights):
        from .aero_grouped_cuda import aero_coeffs_grouped
        return aero_coeffs_grouped(w, alpha_deg, beta_deg, el_deg, row_major=True)
    return aero_coeffs_t(w, alpha_deg, beta_deg, el_deg).T
