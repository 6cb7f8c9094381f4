"""Reed-Solomon decoder over GF(2^8), vectorized with NumPy.

Replaces the reference's Phil Karn port (src/dab/algorithms/
reed_solomon_decoder.{h,cpp}, 525 LoC): syndromes via GF table gathers
(batched over all codewords at once), Berlekamp-Massey + Chien + Forney on
the (rare) corrupted codewords. Field poly x^8+x^4+x^3+x^2+1 (0x11D), fcr=0,
prim=1 — the parameters the reference instantiates for both uses:

  - DAB+ superframe: RS(120,110) = RS(255,245) shortened by 135 (TS 102 563 6.1)
  - packet-mode FEC: RS(204,188) = RS(255,239) shortened by 51 (EN 300 401 5.3.5)

Convention: shortened codeword c[0..n-1]; symbol i sits at polynomial power
n-1-i, so its error locator is X_i = alpha^{n-1-i} (the virtual zero padding
cancels out of the syndromes).

A copy of ``dab_radio_tpu/ops/rs.py``, but for ``rs_syndromes_device``, the
one function there that is device code: here it takes a torch tensor and
computes on the tensor's device, with its constants kept there
(``syndrome_constants``). ``ReedSolomonDecoder.decode(cw, device=...)`` runs
its syndrome stage through it: a caller that holds a device and a large
batch (the serving fleet's byte layer, a CIF of a whole fleet at once)
passes one; the others keep the host gather.

``RS_STATS`` counts the decoder's work, always: ``calls``, ``codewords``,
``device_codewords`` (those whose syndromes were computed on a device),
``gated_rows`` (non-zero syndromes, sent to Berlekamp-Massey) and
``failed_rows`` (returned with -1: uncorrectable).
"""

import functools

import numpy as np

_GF_POLY = 0x11D

RS_STATS = {"calls": 0, "codewords": 0, "device_codewords": 0,
            "gated_rows": 0, "failed_rows": 0}


@functools.lru_cache(maxsize=1)
def _tables():
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _GF_POLY
    exp[255:510] = exp[:255]
    return exp, log


@functools.lru_cache(maxsize=1)
def _mul_table():
    """Full 256x256 GF(2^8) product table (256 KB as int32): one fancy-
    index gather per batched multiply vs the exp/log/mod/where chain —
    the host RS path is the serving fleet's byte-layer hot spot."""
    exp, log = _tables()
    a = np.arange(256)
    t = exp[(log[a][:, None] + log[a][None, :]) % 255].astype(np.int32)
    t[0, :] = 0
    t[:, 0] = 0
    return t


def _gf_mul(a, b):
    """Element-wise GF(2^8) multiply of integer arrays."""
    return _mul_table()[a, b]


def _mul1(a: int, b: int) -> int:
    exp, log = _tables()
    if a == 0 or b == 0:
        return 0
    return int(exp[(log[a] + log[b]) % 255])


def _inv1(a: int) -> int:
    exp, log = _tables()
    return int(exp[(255 - log[a]) % 255])


def _poly_eval(poly, x: int) -> int:
    """Evaluate poly[0] + poly[1]*x + ... at x (Horner, low-degree first)."""
    acc = 0
    for c in reversed(poly):
        acc = _mul1(acc, x) ^ c
    return acc


class ReedSolomonDecoder:
    """Shortened systematic RS decoder, batched over codewords."""

    def __init__(self, nroots: int, pad: int):
        self.nroots = nroots
        self.pad = pad
        self.n = 255 - pad
        self.k = self.n - nroots
        # (t, n) int32: alpha^{j*(n-1-i)} for the one-gather syndrome stage
        exp, _ = _tables()
        pw = np.arange(self.n)[::-1][None, :]
        j = np.arange(nroots)[:, None]
        self._syn_alpha = exp[(j * pw) % 255].astype(np.int32)

    def decode(self, codewords: np.ndarray, device=None):
        """codewords: (..., n) uint8 (message || parity). Returns
        (corrected (..., n) uint8, nb_errors (...,) int32; -1 where
        uncorrectable). With a torch `device` the syndromes are computed
        there (rs_syndromes_device: one copy up, one product, one copy
        back); the same results, worth a launch only for a large batch."""
        cw = np.array(codewords, dtype=np.uint8)
        batch_shape = cw.shape[:-1]
        cw2 = cw.reshape(-1, self.n)

        if device is None:
            # S_j = sum_i c[i] * alpha^{j*(n-1-i)}, all codewords and all j
            # in one (M, t, n) table gather + XOR reduction
            S = np.bitwise_xor.reduce(
                _mul_table()[cw2[:, None, :], self._syn_alpha[None, :, :]],
                axis=2)
        else:
            # on a CUDA device on the constants' own stream, which waits
            # for nothing the caller queued on its own (the fleet's next
            # round)
            import torch
            consts = syndrome_constants(self.nroots, self.pad, device)
            with torch.cuda.stream(consts[3]):
                S = rs_syndromes_device(
                    torch.from_numpy(cw2).to(consts[0].device), self.nroots,
                    self.pad).cpu().numpy()

        nb_errors = np.zeros(cw2.shape[0], dtype=np.int32)
        bad = np.nonzero(S.any(axis=1))[0]
        failed = 0
        if bad.size:
            fixed, nerr = self._decode_many(cw2[bad].astype(np.int32),
                                            S[bad].astype(np.int32))
            cw2[bad] = fixed
            nb_errors[bad] = nerr
            failed = int((nerr < 0).sum())
        RS_STATS["calls"] += 1
        RS_STATS["codewords"] += cw2.shape[0]
        if device is not None:
            RS_STATS["device_codewords"] += cw2.shape[0]
        RS_STATS["gated_rows"] += bad.size
        RS_STATS["failed_rows"] += failed
        return cw2.reshape(*batch_shape, self.n), \
            nb_errors.reshape(batch_shape)

    def _decode_many(self, cw: np.ndarray, S: np.ndarray):
        """Vectorized BM + Chien + Forney over M corrupted codewords at once
        (the scalar _decode_one is the oracle; differential-tested). cw is
        modified and returned; nb_errors -1 marks uncorrectable rows."""
        exp, log = _tables()
        t = self.nroots
        M = cw.shape[0]
        n = self.n

        # --- Berlekamp-Massey, branchless over the batch ---
        C = np.zeros((M, t + 1), np.int32); C[:, 0] = 1
        B = np.zeros((M, t + 1), np.int32); B[:, 0] = 1
        L = np.zeros(M, np.int32)
        m = np.ones(M, np.int32)
        b = np.ones(M, np.int32)
        for step in range(t):
            d = S[:, step].copy()
            for i in range(1, min(step, t) + 1):
                d ^= _gf_mul(C[:, i], S[:, step - i])
            nz = d != 0
            coef = _gf_mul(d, exp[(255 - log[np.maximum(b, 1)]) % 255])
            # B shifted right by per-row m
            idx = np.arange(t + 1)[None, :] - m[:, None]
            Bs = np.where(idx >= 0,
                          np.take_along_axis(B, np.maximum(idx, 0), axis=1), 0)
            upd = _gf_mul(coef[:, None], Bs)
            C_old = C.copy()
            C = np.where(nz[:, None], C ^ upd, C)
            grow = nz & (2 * L <= step)
            B = np.where(grow[:, None], C_old, B)
            b = np.where(grow, d, b)
            L = np.where(grow, step + 1 - L, L)
            m = np.where(grow, 1, m + 1)
        fail = L > t // 2

        # --- Chien search over all positions ---
        xinv_pow = exp[(255 - (np.arange(n)[::-1] % 255)) % 255]  # X_i^{-1}
        P = np.stack([exp[(log[np.maximum(xinv_pow, 1)] * j) % 255]
                      * (xinv_pow != 0) if j else np.ones(n, np.int32)
                      for j in range(t + 1)])                 # (t+1, n) x^j
        ev = np.zeros((M, n), np.int32)
        for j in range(t + 1):
            ev ^= _gf_mul(C[:, j][:, None], P[j][None, :])
        err = ev == 0                                         # (M, n)
        count = err.sum(axis=1).astype(np.int32)
        fail |= count != L

        # --- Forney ---
        Om = np.zeros((M, t), np.int32)
        for j in range(t):
            acc = np.zeros(M, np.int32)
            for k in range(j + 1):
                acc ^= _gf_mul(C[:, k], S[:, j - k])
            Om[:, j] = acc
        Xi = exp[np.arange(n)[::-1] % 255]                    # alpha^{n-1-i}
        num = np.zeros((M, n), np.int32)
        for j in range(t):
            num ^= _gf_mul(Om[:, j][:, None], P[j][None, :])
        # Lambda'(x) evaluated at X_i^{-1}: odd coeffs at powers of y = x^2
        y_pow = _gf_mul(xinv_pow, xinv_pow)
        Cp = C[:, 1::2]
        den = np.zeros((M, n), np.int32)
        yj = np.ones(n, np.int32)
        for j in range(Cp.shape[1]):
            den ^= _gf_mul(Cp[:, j][:, None], yj[None, :])
            yj = _gf_mul(yj, y_pow)
        fail |= (err & (den == 0)).any(axis=1)
        den_inv = exp[(255 - log[np.maximum(den, 1)]) % 255] * (den != 0)
        e = _gf_mul(Xi[None, :], _gf_mul(num, den_inv))
        cw = cw ^ np.where(err & ~fail[:, None], e, 0)

        # --- verify: corrected syndromes must vanish ---
        pw = np.arange(n)[::-1][None, :]
        resid = np.zeros(M, bool)
        for j in range(t):
            resid |= np.bitwise_xor.reduce(
                _gf_mul(cw, exp[(pw * j) % 255]), axis=1) != 0
        fail |= resid
        return cw, np.where(fail, -1, L).astype(np.int32)

    def _decode_one(self, cw, S) -> int:
        exp, log = _tables()
        t = self.nroots

        # Berlekamp-Massey: find error locator Lambda (low-degree first)
        C = [1] + [0] * t
        B = [1] + [0] * t
        L, m, b = 0, 1, 1
        for n in range(t):
            d = S[n]
            for i in range(1, L + 1):
                d ^= _mul1(C[i], S[n - i])
            if d == 0:
                m += 1
            else:
                coef = _mul1(d, _inv1(b))
                if 2 * L <= n:
                    T = C[:]
                    for i in range(t + 1 - m):
                        C[i + m] ^= _mul1(coef, B[i])
                    L, B, b, m = n + 1 - L, T, d, 1
                else:
                    for i in range(t + 1 - m):
                        C[i + m] ^= _mul1(coef, B[i])
                    m += 1
        if L > t // 2:
            return -1

        # Chien search: error at i where Lambda(X_i^{-1}) = 0, X_i = alpha^{n-1-i}
        err_pos = []
        for i in range(self.n):
            x_inv = int(exp[(255 - ((self.n - 1 - i) % 255)) % 255])
            if _poly_eval(C[:L + 1], x_inv) == 0:
                err_pos.append(i)
                if len(err_pos) == L:
                    break
        if len(err_pos) != L:
            return -1

        # Forney: Omega = S * Lambda mod x^t; e_i = X_i*Om(X_i^-1)/Lambda'(X_i^-1)
        Om = [0] * t
        for j in range(t):
            acc = 0
            for k in range(min(j, L) + 1):
                acc ^= _mul1(C[k], S[j - k])
            Om[j] = acc
        Cp = [C[j] for j in range(1, L + 1, 2)]   # Lambda' coeffs at even powers
        for i in err_pos:
            Xi = int(exp[(self.n - 1 - i) % 255])
            Xi_inv = _inv1(Xi)
            num = _poly_eval(Om, Xi_inv)
            # Lambda'(x) = sum_{j odd} C[j] x^{j-1}; substitute y = x^2
            y = _mul1(Xi_inv, Xi_inv)
            den = _poly_eval(Cp, y)
            if den == 0:
                return -1
            cw[i] ^= _mul1(_mul1(Xi, num), _inv1(den))

        # verify: recompute syndromes must vanish
        pw = np.arange(self.n)[::-1]
        for j in range(t):
            if np.bitwise_xor.reduce(_gf_mul(cw, exp[(pw * j) % 255])) != 0:
                return -1
        return L


@functools.lru_cache(maxsize=4)
def dab_plus_rs() -> ReedSolomonDecoder:
    """RS(120,110): 10 parity, 135 pad (DAB+ superframe)."""
    return ReedSolomonDecoder(nroots=10, pad=135)


@functools.lru_cache(maxsize=4)
def packet_rs() -> ReedSolomonDecoder:
    """RS(204,188): 16 parity, 51 pad (packet-mode FEC)."""
    return ReedSolomonDecoder(nroots=16, pad=51)


def rs_encode(msg: np.ndarray, nroots: int, pad: int) -> np.ndarray:
    """Systematic RS encoder (tests/transmitter): msg (..., k) -> (..., k+nroots)."""
    exp, log = _tables()
    g = np.zeros(nroots + 1, dtype=np.int32)
    g[0] = 1
    for i in range(nroots):
        alpha = int(exp[i])
        ng = np.zeros_like(g)
        ng[1:] ^= g[:-1]
        ng ^= _gf_mul(g, alpha)
        g = ng
    g = g[::-1].copy()   # descending order: g[0] = monic x^nroots coefficient
    msg = np.asarray(msg, dtype=np.int32)
    batch_shape = msg.shape[:-1]
    k = msg.shape[-1]
    m2 = msg.reshape(-1, k)
    out = np.zeros((m2.shape[0], k + nroots), dtype=np.int32)
    out[:, :k] = m2
    # LFSR division vectorized across the batch: k steps of (M, nroots) ops
    rem = np.zeros((m2.shape[0], nroots), dtype=np.int32)
    for s in range(k):
        fb = m2[:, s] ^ rem[:, 0]
        rem[:, :-1] = rem[:, 1:]
        rem[:, -1] = 0
        rem ^= _gf_mul(g[1:][None, :], fb[:, None])
    out[:, k:] = rem
    return out.reshape(*batch_shape, k + nroots).astype(np.uint8)


# ---------------------------------------------------------------------------
# syndrome bit matrix
# ---------------------------------------------------------------------------
#
# GF(2^8) is an 8-dimensional vector space over GF(2) and multiplication by a
# constant is linear, so the whole syndrome computation
#   S_j = XOR_i c_i * alpha^{j*(n-1-i)}
# is one fixed binary matrix applied to the codeword bits: a single
# (B, n*8) @ (n*8, t*8) matmul (exact in f32 — column sums < 2^24) followed
# by a parity reduction. So the normal case (clean codeword, all syndromes
# zero) costs one matmul on the device (rs_syndromes_device); only rows
# whose syndrome gate fires need the host Berlekamp-Massey/Forney tail.
# Matches the reference's decode loop entry (reed_solomon_decoder.cpp) which
# always runs the full scalar syndrome loop per codeword on CPU.

@functools.lru_cache(maxsize=None)
def syndrome_bit_matrix(nroots: int, pad: int) -> np.ndarray:
    """(n*8, nroots*8) GF(2) matrix: codeword bits (MSB-first per byte) ->
    syndrome bits (MSB-first per byte)."""
    exp, _ = _tables()
    n = 255 - pad
    M = np.zeros((n * 8, nroots * 8), dtype=np.int8)
    for i in range(n):
        p = n - 1 - i
        for b in range(8):
            v = 1 << (7 - b)
            for j in range(nroots):
                prod = _mul1(v, int(exp[(p * j) % 255]))
                for ob in range(8):
                    M[i * 8 + b, j * 8 + ob] = (prod >> (7 - ob)) & 1
    return M


_SYNDROME_CONSTANTS = {}


def syndrome_constants(nroots: int, pad: int, device):
    """(bit matrix (n*8, nroots*8) float32, bit shifts, byte weights, the
    stream the decoder's device stage runs on: None off CUDA), resident on
    `device` and built once per (nroots, pad, device)."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (nroots, pad, dev)
    if key not in _SYNDROME_CONSTANTS:
        # high priority: its few small kernels go ahead of the blocks of
        # work queued on other streams
        stream = torch.cuda.Stream(dev, priority=-1) \
            if dev.type == "cuda" else None
        with torch.cuda.stream(stream):
            consts = (torch.as_tensor(syndrome_bit_matrix(nroots, pad),
                                      dtype=torch.float32, device=dev),
                      torch.arange(7, -1, -1, dtype=torch.uint8, device=dev),
                      128 >> torch.arange(8, dtype=torch.int32, device=dev),
                      stream)
        if stream is not None:
            stream.synchronize()      # any stream may read them from now on
        _SYNDROME_CONSTANTS[key] = consts
    return _SYNDROME_CONSTANTS[key]


def rs_syndromes_device(codewords, nroots: int, pad: int):
    """Syndromes on the device of `codewords`: (..., n) uint8 tensor ->
    (..., nroots) uint8 tensor on the same device. Use `.any(-1)` as the
    corruption gate; equality with rs_syndromes_numpy is tested.

    The product is float32: CUDA has no int32 matmul, the column sums stay
    below 2^24, and 0/1 inputs are exact even under TF32."""
    import torch
    n = 255 - pad
    M, shifts, weights, _ = syndrome_constants(nroots, pad, codewords.device)
    bits = (codewords[..., :, None].to(torch.uint8) >> shifts) & 1
    bits = bits.reshape(*codewords.shape[:-1], n * 8).to(torch.float32)
    syn_bits = (bits @ M).to(torch.int32) & 1
    syn = (syn_bits.reshape(*codewords.shape[:-1], nroots, 8)
           * weights).sum(dim=-1)
    return syn.to(torch.uint8)


def rs_syndromes_numpy(codewords: np.ndarray, nroots: int, pad: int):
    """NumPy syndromes (same math as
    ReedSolomonDecoder.decode's syndrome stage)."""
    exp, _ = _tables()
    n = 255 - pad
    cw = np.asarray(codewords, np.int32).reshape(-1, n)
    pw = np.arange(n)[::-1][None, :]
    S = np.zeros((cw.shape[0], nroots), dtype=np.int32)
    for j in range(nroots):
        S[:, j] = np.bitwise_xor.reduce(
            _gf_mul(cw, exp[(pw * j) % 255]), axis=1)
    return S.reshape(*np.asarray(codewords).shape[:-1], nroots
                     ).astype(np.uint8)
