"""Self-contained QR code encode/decode (ISO/IEC 18004 subset, no cv2).

The reference generates visitor-pass QR codes with the ``qrcode`` package
and its verify endpoint is broken by construction (reference
visitor.py:1040-1052 feeds PNG bytes to an *encoder*).  This module is the
framework's own working implementation of both directions:

- ``encode(payload)``: byte mode, versions 1-6 (plenty for the pass
  payload — a 24-char visit ObjectId), EC level M, mask chosen by the
  standard penalty rules, Reed-Solomon over GF(2^8)/0x11D.
- ``decode(matrix)``: the clean-synthetic case (axis-aligned screenshot or
  generated PNG): grid detection from the black bounding box + finder
  verification per candidate version, format-info parse (any mask/level),
  de-interleave, RS syndrome check, byte-mode extraction.

cv2 remains only an optional *test oracle* (tests cross-check both
directions against OpenCV's QR coder); no runtime path imports it.

The port's copy of ``facerecognition_infrenceengine_tpu/domain/qr.py``.
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------- GF(256)
_EXP = np.zeros(512, np.int64)
_LOG = np.zeros(256, np.int64)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _rs_generator(necc: int) -> list:
    g = [1]
    for i in range(necc):
        g2 = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            g2[j] ^= _gf_mul(c, int(_EXP[i]))
            g2[j + 1] ^= c
        g = g2
    return g


def _rs_encode(data: list, necc: int) -> list:
    # _rs_generator builds lowest-degree-first; the LFSR divides with the
    # monic leading coefficient at gen[0]
    gen = _rs_generator(necc)[::-1]
    rem = [0] * necc
    for d in data:
        factor = d ^ rem[0]
        rem = rem[1:] + [0]
        if factor:
            lf = _LOG[factor]
            for j in range(necc):
                # gen[0] == 1 is consumed by the shift; gen[j+1] applies here
                if gen[j + 1]:
                    rem[j] ^= int(_EXP[lf + _LOG[gen[j + 1]]])
    return rem


def _rs_syndromes_ok(codeword: list, necc: int) -> bool:
    for i in range(necc):
        s = 0
        for c in codeword:
            s = _gf_mul(s, int(_EXP[i])) ^ c
        if s:
            return False
    return True


# ------------------------------------------------- version / block tables
# (ecc per block, [(n blocks, data codewords per block), ...]) for levels
# L/M/Q/H, versions 1-6 — ample for pass payloads (v6-L holds 134 bytes).
_BLOCKS = {
    1: {"L": (7, [(1, 19)]), "M": (10, [(1, 16)]),
        "Q": (13, [(1, 13)]), "H": (17, [(1, 9)])},
    2: {"L": (10, [(1, 34)]), "M": (16, [(1, 28)]),
        "Q": (22, [(1, 22)]), "H": (28, [(1, 16)])},
    3: {"L": (15, [(1, 55)]), "M": (26, [(1, 44)]),
        "Q": (18, [(2, 17)]), "H": (22, [(2, 13)])},
    4: {"L": (20, [(1, 80)]), "M": (18, [(2, 32)]),
        "Q": (26, [(2, 24)]), "H": (16, [(4, 9)])},
    5: {"L": (26, [(1, 108)]), "M": (24, [(2, 43)]),
        "Q": (18, [(2, 15), (2, 16)]), "H": (22, [(2, 11), (2, 12)])},
    6: {"L": (18, [(2, 68)]), "M": (16, [(4, 27)]),
        "Q": (24, [(4, 19)]), "H": (28, [(4, 15)])},
}
_ALIGN = {1: [], 2: [6, 18], 3: [6, 22], 4: [6, 26], 5: [6, 30], 6: [6, 34]}
_EC_BITS = {"L": 0b01, "M": 0b00, "Q": 0b11, "H": 0b10}
_EC_FROM_BITS = {v: k for k, v in _EC_BITS.items()}


def _format_bits(level: str, mask: int) -> int:
    fmt = (_EC_BITS[level] << 3) | mask
    rem = fmt << 10
    for i in range(14, 9, -1):
        if rem & (1 << i):
            rem ^= 0x537 << (i - 10)
    return ((fmt << 10) | rem) ^ 0x5412


_FORMAT_LOOKUP = {_format_bits(lv, m): (lv, m)
                  for lv in _EC_BITS for m in range(8)}

_MASKS = [
    lambda r, c: (r + c) % 2 == 0,
    lambda r, c: r % 2 == 0,
    lambda r, c: c % 3 == 0,
    lambda r, c: (r + c) % 3 == 0,
    lambda r, c: (r // 2 + c // 3) % 2 == 0,
    lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
    lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
    lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
]


# ------------------------------------------------------ matrix scaffolding
def _function_mask(version: int) -> np.ndarray:
    """Bool [size, size]: True where a function pattern lives."""
    size = 17 + 4 * version
    f = np.zeros((size, size), bool)
    for r0, c0 in ((0, 0), (0, size - 7), (size - 7, 0)):
        f[max(r0 - 1, 0):r0 + 8, max(c0 - 1, 0):c0 + 8] = True
    f[6, :] = True
    f[:, 6] = True
    # format info areas
    f[8, 0:9] = True
    f[0:9, 8] = True
    f[size - 8:, 8] = True
    f[8, size - 8:] = True
    centers = _ALIGN[version]
    for r in centers:
        for c in centers:
            # skip those overlapping finders
            if (r < 9 and c < 9) or (r < 9 and c > size - 10) or \
                    (r > size - 10 and c < 9):
                continue
            f[r - 2:r + 3, c - 2:c + 3] = True
    return f


def _draw_function_patterns(m: np.ndarray, version: int) -> None:
    size = m.shape[0]

    def finder(r0, c0):
        for dr in range(-1, 8):
            for dc in range(-1, 8):
                r, c = r0 + dr, c0 + dc
                if not (0 <= r < size and 0 <= c < size):
                    continue
                inside = 0 <= dr <= 6 and 0 <= dc <= 6
                ring = inside and (dr in (0, 6) or dc in (0, 6))
                core = 2 <= dr <= 4 and 2 <= dc <= 4
                m[r, c] = 1 if (ring or core) else 0

    finder(0, 0)
    finder(0, size - 7)
    finder(size - 7, 0)
    for i in range(8, size - 8):
        m[6, i] = m[i, 6] = (i + 1) % 2
    centers = _ALIGN[version]
    for r in centers:
        for c in centers:
            if (r < 9 and c < 9) or (r < 9 and c > size - 10) or \
                    (r > size - 10 and c < 9):
                continue
            for dr in range(-2, 3):
                for dc in range(-2, 3):
                    m[r + dr, c + dc] = 1 if (abs(dr) == 2 or abs(dc) == 2
                                              or (dr == 0 and dc == 0)) else 0
    m[size - 8, 8] = 1  # dark module


def _place_format(m: np.ndarray, bits: int) -> None:
    size = m.shape[0]
    b = [(bits >> (14 - i)) & 1 for i in range(15)]  # b[0] = MSB (bit 14)
    coords1 = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7),
               (8, 8), (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8),
               (0, 8)]
    for bit, (r, c) in zip(b, coords1):
        m[r, c] = bit
    coords2 = ([(size - 1 - i, 8) for i in range(7)]
               + [(8, size - 8 + i) for i in range(8)])
    for bit, (r, c) in zip(b, coords2):
        m[r, c] = bit


def _read_format(m: np.ndarray):
    size = m.shape[0]
    coords1 = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7),
               (8, 8), (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8),
               (0, 8)]
    coords2 = ([(size - 1 - i, 8) for i in range(7)]
               + [(8, size - 8 + i) for i in range(8)])
    for coords in (coords1, coords2):
        bits = 0
        for r, c in coords:
            bits = (bits << 1) | int(m[r, c])
        if bits in _FORMAT_LOOKUP:
            return _FORMAT_LOOKUP[bits]
    return None


def _data_coords(version: int) -> list:
    """Zigzag module order (the placement sequence for codeword bits)."""
    size = 17 + 4 * version
    f = _function_mask(version)
    coords = []
    c = size - 1
    upward = True
    while c > 0:
        if c == 6:
            c -= 1
        rows = range(size - 1, -1, -1) if upward else range(size)
        for r in rows:
            for dc in (0, -1):
                if not f[r, c + dc]:
                    coords.append((r, c + dc))
        upward = not upward
        c -= 2
    return coords


# ----------------------------------------------------------------- encode
def _penalty(m: np.ndarray) -> int:
    """ISO 18004 mask evaluation (rules N1-N4)."""
    size = m.shape[0]
    score = 0
    for arr in (m, m.T):
        for line in arr:
            run = 1
            for i in range(1, size):
                if line[i] == line[i - 1]:
                    run += 1
                else:
                    if run >= 5:
                        score += 3 + run - 5
                    run = 1
            if run >= 5:
                score += 3 + run - 5
    blocks = (m[:-1, :-1] == m[1:, :-1]) & (m[:-1, :-1] == m[:-1, 1:]) \
        & (m[:-1, :-1] == m[1:, 1:])
    score += 3 * int(blocks.sum())
    pat = np.array([1, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0], np.int8)
    for arr in (m, m.T):
        for line in arr:
            for i in range(size - 10):
                w = line[i:i + 11]
                if (w == pat).all() or (w == pat[::-1]).all():
                    score += 40
    dark = int(m.sum())
    k = abs(dark * 100 // (size * size) - 50) // 5
    score += 10 * k
    return score


def encode(payload: bytes | str, level: str = "M") -> np.ndarray:
    """payload -> module matrix (uint8 [size, size], 1 = dark)."""
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    version = None
    for v in range(1, 7):
        necc, groups = _BLOCKS[v][level]
        cap = sum(n * k for n, k in groups) - 2  # mode + length overhead
        if len(payload) <= cap:
            version = v
            break
    if version is None:
        raise ValueError(f"payload too large for v1-6 QR at level {level} "
                         f"({len(payload)} bytes)")
    necc, groups = _BLOCKS[version][level]
    n_data = sum(n * k for n, k in groups)

    bits = []

    def push(val, n):
        for i in range(n - 1, -1, -1):
            bits.append((val >> i) & 1)

    push(0b0100, 4)          # byte mode
    push(len(payload), 8)    # v1-9 length field
    for byte in payload:
        push(byte, 8)
    push(0, min(4, n_data * 8 - len(bits)))  # terminator
    while len(bits) % 8:
        bits.append(0)
    data = [sum(b << (7 - i) for i, b in enumerate(bits[j:j + 8]))
            for j in range(0, len(bits), 8)]
    pad = (0xEC, 0x11)
    i = 0
    while len(data) < n_data:
        data.append(pad[i % 2])
        i += 1

    # split into blocks, RS per block, interleave
    blocks, pos = [], 0
    for n, k in groups:
        for _ in range(n):
            blocks.append(data[pos:pos + k])
            pos += k
    eccs = [_rs_encode(b, necc) for b in blocks]
    seq = []
    for i in range(max(len(b) for b in blocks)):
        for b in blocks:
            if i < len(b):
                seq.append(b[i])
    for i in range(necc):
        for e in eccs:
            seq.append(e[i])

    size = 17 + 4 * version
    base = np.zeros((size, size), np.uint8)
    _draw_function_patterns(base, version)
    coords = _data_coords(version)
    bitstream = [(cw >> (7 - i)) & 1 for cw in seq for i in range(8)]
    bitstream += [0] * (len(coords) - len(bitstream))  # remainder bits

    best = None
    for mask in range(8):
        m = base.copy()
        mf = _MASKS[mask]
        for (r, c), bit in zip(coords, bitstream):
            m[r, c] = bit ^ (1 if mf(r, c) else 0)
        _place_format(m, _format_bits(level, mask))
        score = _penalty(m)
        if best is None or score < best[0]:
            best = (score, m)
    return best[1]


def render(matrix: np.ndarray, module_px: int = 10,
           border_modules: int = 4) -> np.ndarray:
    """Module matrix -> grayscale uint8 image (0 dark / 255 light)."""
    img = np.where(np.kron(matrix, np.ones((module_px, module_px),
                                           np.uint8)), 0, 255).astype(np.uint8)
    pad = border_modules * module_px
    return np.pad(img, pad, constant_values=255)


# ----------------------------------------------------------------- decode
def _sample_grid(gray: np.ndarray, size: int, r0, r1, c0, c1) -> np.ndarray:
    rs = np.clip((r0 + (np.arange(size) + 0.5) * (r1 - r0) / size)
                 .astype(int), 0, gray.shape[0] - 1)
    cs = np.clip((c0 + (np.arange(size) + 0.5) * (c1 - c0) / size)
                 .astype(int), 0, gray.shape[1] - 1)
    return (gray[np.ix_(rs, cs)] < 128).astype(np.uint8)


def _finders_ok(m: np.ndarray) -> bool:
    size = m.shape[0]
    ref = np.zeros((7, 7), np.uint8)
    ref[0, :] = ref[6, :] = ref[:, 0] = ref[:, 6] = 1
    ref[2:5, 2:5] = 1
    for r0, c0 in ((0, 0), (0, size - 7), (size - 7, 0)):
        win = m[r0:r0 + 7, c0:c0 + 7]
        if (win != ref).sum() > 2:  # tolerate resampling nicks
            return False
    return True


def decode_matrix(m: np.ndarray) -> bytes | None:
    """Module matrix -> payload bytes (clean-synthetic decode)."""
    size = m.shape[0]
    version = (size - 17) // 4
    if version not in _BLOCKS or 17 + 4 * version != size:
        return None
    fmt = _read_format(m)
    if fmt is None:
        return None
    level, mask = fmt
    mf = _MASKS[mask]
    coords = _data_coords(version)
    bits = [int(m[r, c]) ^ (1 if mf(r, c) else 0) for r, c in coords]
    seq = [sum(b << (7 - i) for i, b in enumerate(bits[j:j + 8]))
           for j in range(0, len(bits) - 7, 8)]

    necc, groups = _BLOCKS[version][level]
    sizes = [k for n, k in groups for _ in range(n)]
    nblocks = len(sizes)
    n_data = sum(sizes)
    if len(seq) < n_data + necc * nblocks:
        return None
    blocks = [[] for _ in range(nblocks)]
    it = iter(seq[:n_data])
    for i in range(max(sizes)):
        for b, k in zip(blocks, sizes):
            if i < k:
                b.append(next(it))
    eccs = [[] for _ in range(nblocks)]
    it = iter(seq[n_data:n_data + necc * nblocks])
    for i in range(necc):
        for e in eccs:
            e.append(next(it))
    data = []
    for b, e in zip(blocks, eccs):
        if not _rs_syndromes_ok(b + e, necc):
            return None  # clean-synthetic decoder: no error correction
        data.extend(b)

    # parse byte mode
    stream = [(cw >> (7 - i)) & 1 for cw in data for i in range(8)]

    def take(n):
        nonlocal pos
        v = 0
        for _ in range(n):
            v = (v << 1) | stream[pos]
            pos += 1
        return v

    pos = 0
    if take(4) != 0b0100:
        return None
    n = take(8)
    if pos + 8 * n > len(stream):
        return None
    return bytes(take(8) for _ in range(n))


def _finder_candidates(dark: np.ndarray) -> list:
    """(row, col, module_px) candidates via the classic 1:1:3:1:1 scan —
    locates finder patterns even when the QR sits inside a larger document
    (the visitor pass embeds it among other dark graphics)."""
    h, w = dark.shape
    out = []
    step = max(1, h // 400)
    for r in range(0, h, step):
        row = dark[r]
        # run-length encode
        edges = np.flatnonzero(np.diff(row.astype(np.int8)))
        bounds = np.concatenate([[-1], edges, [w - 1]])
        lengths = np.diff(bounds)
        starts = bounds[:-1] + 1
        vals = row[starts]
        for i in range(len(lengths) - 4):
            if not vals[i]:
                continue  # quintuple starts dark
            a, b, c, d, e = lengths[i:i + 5]
            mod = (a + b + c + d + e) / 7.0
            if mod < 2:
                continue
            if (abs(a - mod) <= mod * 0.6 and abs(b - mod) <= mod * 0.6
                    and abs(c - 3 * mod) <= mod * 1.2
                    and abs(d - mod) <= mod * 0.6
                    and abs(e - mod) <= mod * 0.6):
                cx = int(starts[i + 2] + lengths[i + 2] // 2)
                # verify the same ratio vertically through (r, cx)
                col = dark[:, cx]
                up = r
                while up > 0 and col[up - 1] == col[r]:
                    up -= 1
                down = r
                while down < h - 1 and col[down + 1] == col[r]:
                    down += 1
                core = down - up + 1
                if not col[r] or abs(core - 3 * mod) > 2 * mod:
                    continue
                out.append(((up + down) // 2, cx, mod))
    # cluster candidates within ~2 modules and of a like module size: a
    # finder's scans must not merge with a nearby run of data modules (a
    # wider 1:1:3:1:1 match), whose average would move the finder off centre
    clusters: list = []
    for r, c, mod in out:
        for cl in clusters:
            if (abs(cl[0] - r) < 3 * mod and abs(cl[1] - c) < 3 * mod
                    and 2 / 3 < mod / cl[2] < 1.5):
                cl[0] = (cl[0] + r) / 2
                cl[1] = (cl[1] + c) / 2
                cl[2] = (cl[2] + mod) / 2
                break
        else:
            clusters.append([float(r), float(c), float(mod)])
    return clusters


def _decode_at(gray: np.ndarray, r0, r1, c0, c1) -> bytes | None:
    for version in range(1, 7):
        size = 17 + 4 * version
        m = _sample_grid(gray, size, r0, r1, c0, c1)
        if _finders_ok(m):
            payload = decode_matrix(m)
            if payload is not None:
                return payload
    return None


def decode_image(gray: np.ndarray) -> bytes | None:
    """Grayscale uint8 image -> payload (axis-aligned clean QR, standalone
    or embedded in a larger document like the visitor pass)."""
    dark = gray < 128
    rows = np.flatnonzero(dark.any(axis=1))
    cols = np.flatnonzero(dark.any(axis=0))
    if not len(rows) or not len(cols):
        return None
    # fast path: the QR is the only dark content
    payload = _decode_at(gray, int(rows[0]), int(rows[-1]) + 1,
                         int(cols[0]), int(cols[-1]) + 1)
    if payload is not None:
        return payload
    # localization: three finder patterns bound the symbol
    finders = _finder_candidates(dark)
    if len(finders) < 3:
        return None
    # try every triple forming an axis-aligned L (TL, TR, BL)
    for tl in finders:
        for tr in finders:
            for bl in finders:
                if tr is tl or bl is tl or bl is tr:
                    continue
                mod = (tl[2] + tr[2] + bl[2]) / 3.0
                if (abs(tr[0] - tl[0]) > 4 * mod      # TR level with TL
                        or abs(bl[1] - tl[1]) > 4 * mod  # BL under TL
                        or tr[1] - tl[1] < 7 * mod
                        or bl[0] - tl[0] < 7 * mod
                        or abs((tr[1] - tl[1]) - (bl[0] - tl[0])) > 6 * mod):
                    continue
                r0 = tl[0] - 3.5 * mod
                c0 = tl[1] - 3.5 * mod
                r1 = bl[0] + 3.5 * mod
                c1 = tr[1] + 3.5 * mod
                payload = _decode_at(gray, int(round(r0)), int(round(r1)),
                                     int(round(c0)), int(round(c1)))
                if payload is not None:
                    return payload
    # one finder lost among the document's other dark runs: two that stand
    # level (TL, TR) or one above the other (TL, BL) give the symbol's square
    for a in finders:
        for b in finders:
            mod = (a[2] + b[2]) / 2.0
            if abs(b[0] - a[0]) <= 4 * mod and b[1] - a[1] >= 7 * mod:
                side = b[1] - a[1]  # a TL, b TR
            elif abs(b[1] - a[1]) <= 4 * mod and b[0] - a[0] >= 7 * mod:
                side = b[0] - a[0]  # a TL, b BL
            else:
                continue
            r0, c0 = a[0] - 3.5 * mod, a[1] - 3.5 * mod
            payload = _decode_at(gray, int(round(r0)), int(round(r0 + side + 7 * mod)),
                                 int(round(c0)), int(round(c0 + side + 7 * mod)))
            if payload is not None:
                return payload
    return None
