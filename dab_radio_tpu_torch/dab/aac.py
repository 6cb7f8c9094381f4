"""DAB+ audio superframe layer (ETSI TS 102 563).

Parity surface: reference src/dab/audio/aac_frame_processor.{h,cpp}:
accumulate 5 DAB logical frames into a superframe, column-interleaved
RS(120,110) correction, firecode CRC16 sync with a desync counter (max 10),
superframe header parse (dac_rate/sbr/ps/stereo/mpeg-surround -> sampling
rate and 2/3/4/6 access units), 12-bit AU start offsets, per-AU CRC16.

Includes the encoder inverse (superframe builder) for closed-loop tests and
the ensemble transmitter, plus MPEG-4 AudioSpecificConfig / ADTS header
generation (reference src/dab/audio/aac_audio_decoder.cpp:86-296) for
bitstream export and codec initialisation.
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..ops.crc import (_crc16_table, crc16, crc16_batch, crc16_bounds,
                       firecode_crc16)
from ..ops.rs import dab_plus_rs, rs_encode

TOTAL_DAB_FRAMES = 5
DESYNC_MAX_COUNT = 10
RS_MESSAGE, RS_DATA, RS_PARITY, RS_PAD = 120, 110, 10, 135

# The superframe layer's batched work, always counted: finish_batch's calls,
# the superframes it was handed, and those that returned access units;
# SuperframeIntake's steps, the frames it took into its buffers, and those
# it firecode-checked for rows out of sync
SF_STATS = {"calls": 0, "superframes": 0, "finished": 0,
            "intake_calls": 0, "intake_frames": 0, "hunted": 0}


@dataclass(frozen=True)
class SuperFrameHeader:
    sampling_rate: int            # 32000 | 48000
    is_stereo: bool
    sbr: bool                     # spectral band replication (HE-AAC)
    ps: bool                      # parametric stereo (HE-AAC v2)
    mpeg_surround: int

    @property
    def num_aus(self) -> int:
        dac = self.sampling_rate == 48000
        if self.sbr:
            return 3 if dac else 2
        return 6 if dac else 4

    @property
    def core_sample_rate(self) -> int:
        """AAC core rate (halved when SBR upsamples)."""
        return self.sampling_rate // 2 if self.sbr else self.sampling_rate


def _parse_header(d: int) -> SuperFrameHeader:
    """The superframe header of its audio-parameter byte (byte 2)."""
    return SuperFrameHeader(
        sampling_rate=48000 if (d >> 6) & 1 else 32000,
        is_stereo=bool((d >> 4) & 1),
        sbr=bool((d >> 5) & 1),
        ps=bool((d >> 3) & 1),
        mpeg_surround=d & 0b111)


def _finish_tables():
    """What finish_batch looks up, by a superframe's bytes 0..10.

    Each byte's part, summed over the 11, of 9 numbers: 7 AU bounds (the
    first AU's offset, after the 3 header bytes and the 12-bit starts of
    the others, from the header byte 2; the 12-bit starts of AUs 1..5 from
    bytes 3..10); the firecode check, whose bit b holds in a 4-bit field
    at 4 * b (the firecode is linear: init 0, no final xor, so the two
    firecode bytes xor the CRC of bytes 2..10 are the xor of one 16-bit
    entry a byte, which the fields' parities give, all even where it
    holds); and the count of nonzero bytes. By the header byte: its header,
    and which bounds lie past the last AU's start (the payload's end goes
    there). And the AU CRC16 over an AU with its own CRC bytes, one
    constant where they agree, which no block shorter than 2 bytes gives.
    """
    headers = tuple(_parse_header(d) for d in range(256))
    num = np.array([h.num_aus for h in headers])
    v = np.arange(256)
    check = np.zeros((11, 256), np.int64)
    check[0], check[1] = v << 8, v
    lut = _crc16_table(0x782F).astype(np.int64)
    for i in range(2, 11):
        reg = lut[v]                          # byte i, then 10 - i zeros
        for _ in range(10 - i):
            reg = ((reg << 8) & 0xFFFF) ^ lut[reg >> 8]
        check[i] = reg
    parts = np.zeros((11, 256, 9), np.int64)
    parts[2, :, 0] = 3 + (12 * (num - 1) + 7) // 8
    for k in range(1, 6):
        j = 3 + 12 * (k - 1) // 8             # bytes j and j + 1
        if k % 2:
            parts[j, :, k] += v << 4
            parts[j + 1, :, k] += v >> 4
        else:
            parts[j, :, k] += (v & 0xF) << 8
            parts[j + 1, :, k] += v
    for bit in range(16):
        parts[:, :, 7] += ((check >> bit) & 1) << (4 * bit)
    parts[:, 1:, 8] = 1
    residue = int(crc16_batch(np.zeros((1, 2), np.uint8))[0])
    return (headers, parts.reshape(-1, 9), np.arange(7) >= num[:, None],
            residue)


(_HEADERS, _PARTS, _PAST_AUS, _AU_RESIDUE) = _finish_tables()
_PARTS_ROW = np.arange(11) * 256
_EVEN = 0x1111111111111111          # the firecode fields' parity bits
_RS_FAILED = 0xFFFF


def _firecode_holds(parts: np.ndarray) -> np.ndarray:
    """_firecode_ok of header windows from their _PARTS sums (H, 9) ->
    (H,) bool: the firecode holds and the window is not all zero."""
    return ((parts[:, 7] & _EVEN) == 0) & (parts[:, 8] > 0)


def _write_au_starts(vals: List[int]) -> bytes:
    acc, nbits = 0, 0
    out = bytearray()
    for v in vals:
        acc = (acc << 12) | (v & 0xFFF)
        nbits += 12
        while nbits >= 8:
            out.append((acc >> (nbits - 8)) & 0xFF)
            nbits -= 8
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


class SuperframeProcessor:
    """Streaming DAB+ superframe decoder: push one logical frame per CIF;
    returns (header, [au_payloads]) whenever a superframe validates."""

    def __init__(self):
        self.frame_bytes: Optional[int] = None
        self.buffer: List[bytes] = []
        self.is_synced = False
        self.desync_count = 0
        self.stats = {"firecode_errors": 0, "rs_errors": 0, "au_crc_errors": 0,
                      "superframes": 0, "rs_corrected_bytes": 0}

    def process_frame(self, frame: bytes):
        sf = self.push_frame(frame)
        if sf is None:
            return None
        arr = np.frombuffer(sf, dtype=np.uint8).reshape(
            RS_MESSAGE, len(sf) // RS_MESSAGE)
        corrected, nerr = dab_plus_rs().decode(arr.T.copy())
        return self.finish(corrected, nerr)

    def push_frame(self, frame: bytes):
        """Accumulation half of process_frame: returns the raw assembled
        superframe bytes once TOTAL_DAB_FRAMES are buffered, else None.
        The caller must RS-decode the column-deinterleaved codewords and
        call finish() before the next push — this split lets a serving
        fleet batch ONE RS decode across every stream's completed
        superframes per round (FusedFleet._consume) instead of paying
        the Berlekamp-Massey dispatch overhead per superframe."""
        if self.frame_bytes != len(frame):
            self.frame_bytes = len(frame)
            self.buffer.clear()
            self.is_synced = False

        if self.desync_count >= DESYNC_MAX_COUNT:
            self.desync_count = 0
            self.is_synced = False

        if not self.is_synced and not self.buffer:
            if not self._firecode_ok(frame):
                self.stats["firecode_errors"] += 1
                return None

        self.buffer.append(bytes(frame))
        if len(self.buffer) < TOTAL_DAB_FRAMES:
            return None
        sf = b"".join(self.buffer)
        self.buffer.clear()
        return sf

    @staticmethod
    def _firecode_ok(buf: bytes) -> bool:
        rx = (buf[0] << 8) | buf[1]
        # all-zero header window: CRC16(init 0) of zeros is 0, which would
        # false-sync inside zero padding regions; a real superframe header
        # is never all-zero (byte 2 carries the audio params)
        if rx == 0 and not any(buf[2:11]):
            return False
        return firecode_crc16(buf[2:11]) == rx

    def finish(self, corrected: np.ndarray, nerr: np.ndarray):
        """Post-RS half of process_frame: corrected (n_cols, 120) uint8
        codewords + per-codeword error counts (-1 = uncorrectable) from
        push_frame's superframe. Returns (header, [au_payloads]) or
        None. The batch of one of finish_batch."""
        return SuperframeProcessor.finish_batch([self], corrected, nerr)[0]

    @staticmethod
    def finish_batch(processors, corrected: np.ndarray, nerr: np.ndarray):
        """finish for K superframes at once, one from each of `processors`
        (in order), whose codewords are concatenated in `corrected`
        (sum of n_cols, 120) with their `nerr`. Returns one result a
        processor, each what its own finish would return, with the same
        counters and sync state. The numeric work (RS failures, the
        transposed copy, firecode, header, AU starts, AU CRC16) is done
        for the batch at once; the loop over superframes only updates
        each processor and cuts its AU bytes. Called through the class."""
        K = len(processors)
        if not K:
            SF_STATS["calls"] += 1
            return []
        cols = [p.frame_bytes * TOTAL_DAB_FRAMES // RS_MESSAGE
                for p in processors]
        widths = sorted(set(cols))
        rows = len(nerr)
        if sum(cols) != rows:
            raise ValueError(f"{rows} codewords for superframes of "
                             f"{sum(cols)}")
        order = None
        if len(widths) == 1:
            n = widths[0]
            row0 = np.arange(0, rows, n)
        else:
            # a mixed batch is taken grouped by n_cols (a processor keeps
            # one size, so each one's superframes keep their order)
            n = np.array(cols)
            order = np.argsort(n, kind="stable")
            ends = np.cumsum(n)[order]
            n = n[order]
            row0 = np.cumsum(n) - n
            index = np.repeat(ends - n - row0, n) + np.arange(rows)
            corrected, nerr = corrected[index], nerr[index]
            processors = [processors[k] for k in order.tolist()]
            n = n[:, None]
        # each superframe's corrected bytes, at or past _RS_FAILED where a
        # codeword failed (-1, which the mask turns into _RS_FAILED; the
        # others count at most 5 of the 65,535)
        fixed = np.add.reduceat(nerr & _RS_FAILED, row0).tolist()

        # one transposed copy of the batch, a superframe at `base`
        base = row0 * RS_MESSAGE
        groups, r = [], 0
        for w in widths:
            m = cols.count(w) * w
            groups.append(corrected[r:r + m].reshape(-1, w, RS_MESSAGE)
                          .transpose(0, 2, 1).reshape(-1))
            r += m
        buf = groups[0] if order is None else np.concatenate(groups)
        head = buf.reshape(K, -1)[:, :11] if order is None \
            else buf[base[:, None] + np.arange(11)]

        # by the header windows: each firecode check and nonzero count,
        # and the AU bounds, the payload's end past the last AU's start
        d = head[:, 2]
        parts = _PARTS[head + _PARTS_ROW].sum(axis=1)
        fire_ok = _firecode_holds(parts).tolist()
        size = n * RS_MESSAGE
        bounds = np.where(_PAST_AUS[d], n * RS_DATA, parts[:, :7])
        # one CRC call over every AU of the batch, in place in `buf`, the
        # last superframe's bounds first, so that the block from each
        # superframe's last bound to the next one's first goes back and is
        # empty; an AU is kept if it ends inside its superframe and its
        # CRC holds
        edges = np.empty(7 * K + 1, np.int64)
        rowed = edges[:-1].reshape(K, 7)[::-1]
        np.add(np.minimum(bounds, size), base[:, None], out=rowed)
        edges[-1] = edges[-2]
        crc = crc16_bounds(buf, edges).reshape(K, 7)[::-1]
        good = ((crc[:, :-1] == _AU_RESIDUE) > (bounds[:, 1:] > size)).tolist()
        data = buf.tobytes()

        # the only per-superframe work: each processor's state, in order,
        # and its AUs cut from `data`
        out = []
        for p, h, fixed_k, fire_ok_k, e, g in zip(
                processors, d.tolist(), fixed, fire_ok, rowed.tolist(), good):
            st = p.stats
            if fixed_k >= _RS_FAILED:
                st["rs_errors"] += 1
                p.desync_count += 1
                out.append(None)
                continue
            st["rs_corrected_bytes"] += fixed_k
            if not fire_ok_k:
                st["firecode_errors"] += 1
                p.desync_count += 1
                out.append(None)
                continue
            p.desync_count = 0
            p.is_synced = True
            header = _HEADERS[h]
            aus = [data[x:y - 2] for x, y, ok in zip(e, e[1:], g) if ok]
            st["au_crc_errors"] += header.num_aus - len(aus)
            st["superframes"] += 1
            out.append((header, aus))
        SF_STATS["calls"] += 1
        SF_STATS["superframes"] += K
        SF_STATS["finished"] += K - out.count(None)
        if order is not None:
            back = [None] * K
            for k, res in zip(order.tolist(), out):
                back[k] = res
            out = back
        return out


_NO_ROWS = np.zeros(0, np.int64)


class _Rows:
    """The rows of a SuperframeIntake of one frame width: a ring of
    TOTAL_DAB_FRAMES frames a row, how many each holds, and each row's
    sync state as arrays."""

    def __init__(self, index, where, processors, nb):
        R = len(index)
        self.index = np.asarray(index, np.int64)    # rows of the intake
        self.where = where              # their place in a round's array
        self.lead = None                # the leading shape `where` was seen in
        self.procs = processors
        self.nb = nb
        self.n_cols = nb * TOTAL_DAB_FRAMES // RS_MESSAGE
        if self.n_cols * RS_MESSAGE != nb * TOTAL_DAB_FRAMES:
            raise ValueError(f"frames of {nb} bytes do not make a superframe "
                             f"of whole codewords")
        self.ring = np.zeros((R, TOTAL_DAB_FRAMES, nb), np.uint8)
        self.count = np.zeros(R, np.int64)
        for i, p in enumerate(processors):
            if p.frame_bytes != nb:
                # push_frame's rule for a frame of another width
                p.frame_bytes = nb
                p.buffer.clear()
                p.is_synced = False
            for k, frame in enumerate(p.buffer):
                self.ring[i, k] = np.frombuffer(frame, np.uint8)
            self.count[i] = len(p.buffer)
        self.synced = np.zeros(R, bool)
        self.desync = np.zeros(R, np.int64)
        self.read_back(np.arange(R))
        self.frames = None              # the round's frames, (R, C, nb)
        self.done = _NO_ROWS            # the last step's completed rows

    def load(self, round_bytes):
        lead = round_bytes.shape[:len(self.where)]
        if lead != self.lead:
            # rows that are every row of the array, in order, read it in
            # place; others are gathered
            self.lead = lead
            self.whole = len(self.index) == np.prod(lead) and bool(
                (np.ravel_multi_index(self.where, lead)
                 == np.arange(len(self.index))).all())
        if self.whole:
            self.frames = round_bytes.reshape(
                len(self.index), *round_bytes.shape[len(lead):])
        else:
            self.frames = round_bytes[(*self.where, slice(None))]
        self.frames = self.frames[:, :, :self.nb]

    def read_back(self, rows):
        """Take the sync state of the processors of `rows` (indices into
        this group), which finish_batch changes."""
        procs = self.procs if len(rows) == len(self.procs) \
            else [self.procs[i] for i in rows.tolist()]
        self.synced[rows] = [p.is_synced for p in procs]
        self.desync[rows] = [p.desync_count for p in procs]
        self._settle()

    def _settle(self):
        # steady: every row in sync, none at the desync limit, all at the
        # same slot; a step then only takes the frames
        self.steady = bool(self.synced.all()) and \
            int(self.desync.max()) < DESYNC_MAX_COUNT and \
            bool((self.count == self.count[0]).all())

    def step(self, c):
        """push_frame of CIF c for every row -> the rows (indices into
        this group) whose superframes it completed, and their codewords
        (rows, n_cols, 120)."""
        frames = self.frames[:, c]
        steady = self.steady
        lost = _NO_ROWS
        if not steady:
            stale = self.desync >= DESYNC_MAX_COUNT
            if stale.any():
                for i in np.flatnonzero(stale).tolist():
                    p = self.procs[i]
                    p.desync_count = 0
                    p.is_synced = False
                self.desync[stale] = 0
                self.synced[stale] = False
            hunt = ~self.synced & (self.count == 0)
            if hunt.any():
                hunt = np.flatnonzero(hunt)
                SF_STATS["hunted"] += len(hunt)
                parts = _PARTS[frames[hunt, :11] + _PARTS_ROW].sum(axis=1)
                lost = hunt[~_firecode_holds(parts)]
                for i in lost.tolist():
                    self.procs[i].stats["firecode_errors"] += 1
        k = int(self.count[0])
        if steady or not len(lost) and (self.count == k).all():
            # every row takes its frame into the same slot
            taken = len(frames)
            self.ring[:, k] = frames
            self.count += 1
            full = k + 1 == TOTAL_DAB_FRAMES
            done = np.arange(taken) if full else _NO_ROWS
        else:
            take = np.ones(len(frames), bool)
            take[lost] = False
            rows = np.flatnonzero(take)
            taken = len(rows)
            self.ring[rows, self.count[rows]] = frames[rows]
            self.count[rows] += 1
            done = np.flatnonzero(self.count == TOTAL_DAB_FRAMES)
            full = len(done) == len(frames)
        SF_STATS["intake_frames"] += taken
        self.done = done
        if len(done):
            self.count[done] = 0
        if not steady:
            self._settle()
        if not len(done):
            return done, None
        # a superframe's bytes are (120, n_cols), codeword j its column j:
        # a transposed view, which the RS decode copies once
        ring = self.ring if full else self.ring[done]
        cw = ring.reshape(-1, RS_MESSAGE, self.n_cols)
        return done, cw.transpose(0, 2, 1)

    def write_back(self):
        for p, frames, n, synced, desync in zip(
                self.procs, self.ring, self.count.tolist(),
                self.synced.tolist(), self.desync.tolist()):
            p.buffer = [f.tobytes() for f in frames[:n]]
            p.is_synced = synced
            p.desync_count = desync


class SuperframeIntake:
    """push_frame for many processors at once: a serving fleet's DAB+
    subchannels, one row each, take a CIF's frames in one array step.

    Each row keeps what push_frame keeps (its buffered frames, is_synced,
    desync_count) as arrays, grouped by frame width: a ring of
    TOTAL_DAB_FRAMES frames a row. A step applies push_frame's rules to
    every row in the same order: a row at DESYNC_MAX_COUNT resets and is out
    of sync; a row out of sync with nothing buffered takes a frame only if
    its firecode holds (else firecode_errors counts it on the row's
    processor); the frame goes into the ring; rows with TOTAL_DAB_FRAMES
    frames are the superframes completed, handed out as one codeword matrix
    ready for the RS decode. The caller finishes them with
    SuperframeProcessor.finish_batch and then calls read_back(), since
    finish_batch changes the processors' sync state.

    While the intake holds them, the processors' `buffer` lists are stale:
    write_back() puts the buffered frames there (before a snapshot). A
    processor taken in has its row's frame width, as after its first
    push_frame. The tuner's one frame at a time stays with push_frame."""

    def __init__(self, processors, frame_bytes, at):
        """processors, and the frame bytes of each, one a row; `at`, the
        rows' places in the arrays that load() takes: index arrays, one an
        axis before the frames'."""
        groups = {}
        for i, nb in enumerate(frame_bytes):
            groups.setdefault(nb, []).append(i)
        self.groups = [
            _Rows(rows, tuple(np.asarray(a)[rows] for a in at),
                  [processors[i] for i in rows], nb)
            for nb, rows in sorted(groups.items())]

    def load(self, round_bytes):
        """Take a round's frames, one gather a frame width: round_bytes
        (..., C, W) uint8 holds C frames of each row where `at` points, in
        the first bytes of W (at least the row's frame width)."""
        for g in self.groups:
            g.load(round_bytes)

    def step(self, c):
        """push_frame of frame c of the loaded round for every row ->
        (rows, processors, codewords): the rows whose superframes the step
        completed (grouped by frame width, in row order within a width),
        their processors, and their codewords in the same order, (..., 120)
        (a view of the ring where one width completed: valid until the next
        step), as ReedSolomonDecoder.decode takes them. rows is empty and
        codewords None if none completed."""
        rows, procs, cws = [], [], []
        for g in self.groups:
            done, cw = g.step(c)
            if len(done):
                rows.append(g.index[done])
                procs += g.procs if len(done) == len(g.procs) \
                    else [g.procs[i] for i in done.tolist()]
                cws.append(cw)
        SF_STATS["intake_calls"] += 1
        if not rows:
            return _NO_ROWS, [], None
        if len(rows) == 1:
            return rows[0], procs, cws[0]
        return np.concatenate(rows), procs, np.concatenate(
            [cw.reshape(-1, RS_MESSAGE) for cw in cws])

    def read_back(self):
        """Take back the sync state of the last step's completed rows from
        their processors, after finish_batch."""
        for g in self.groups:
            if len(g.done):
                g.read_back(g.done)

    def write_back(self):
        """Put each row's buffered frames and sync state into its
        processor, as push_frame would have left them."""
        for g in self.groups:
            g.write_back()


class SuperframeEncoder:
    """Inverse path: AU payloads -> 5 logical frames (tests/transmitter)."""

    def __init__(self, frame_bytes: int, header: SuperFrameHeader):
        if (frame_bytes * TOTAL_DAB_FRAMES) % RS_MESSAGE:
            raise ValueError("superframe size must be a multiple of 120")
        self.frame_bytes = frame_bytes
        self.header = header
        self.n_cols = frame_bytes * TOTAL_DAB_FRAMES // RS_MESSAGE

    def au_capacity(self) -> int:
        """Total AU payload bytes (excluding per-AU CRCs) in one superframe."""
        num_aus = self.header.num_aus
        au_start_bytes = -(-(12 * (num_aus - 1)) // 8)
        return RS_DATA * self.n_cols - 3 - au_start_bytes - 2 * num_aus

    def encode(self, au_payloads: List[bytes]) -> List[bytes]:
        h = self.header
        num_aus = h.num_aus
        assert len(au_payloads) == num_aus
        au_start_bytes = -(-(12 * (num_aus - 1)) // 8)
        data_len = RS_DATA * self.n_cols

        aus = [p + crc16(p).to_bytes(2, "big") for p in au_payloads]
        starts = [3 + au_start_bytes]
        for a in aus[:-1]:
            starts.append(starts[-1] + len(a))
        # TS 102 563: the last AU extends to the end of the payload, so the
        # AUs must exactly fill it (au_capacity() gives the byte budget)
        if starts[-1] + len(aus[-1]) != data_len:
            raise ValueError(
                f"access units must exactly fill the superframe payload: "
                f"{starts[-1] + len(aus[-1])} != {data_len}")

        d = ((1 if h.sampling_rate == 48000 else 0) << 6) \
            | (int(h.sbr) << 5) | (int(h.is_stereo) << 4) \
            | (int(h.ps) << 3) | (h.mpeg_surround & 0b111)
        body = bytearray(data_len)
        body[2] = d
        body[3:3 + au_start_bytes] = _write_au_starts(starts[1:])
        pos = starts[0]
        for a in aus:
            body[pos:pos + len(a)] = a
            pos += len(a)
        fc = firecode_crc16(bytes(body[2:11]))
        body[0], body[1] = fc >> 8, fc & 0xFF

        # RS parity per column-interleaved codeword
        msgs = np.frombuffer(bytes(body), dtype=np.uint8).reshape(RS_DATA, self.n_cols).T
        codewords = rs_encode(msgs, RS_PARITY, RS_PAD)          # (n_cols, 120)
        sf = codewords.T.reshape(-1).tobytes()
        return [sf[i * self.frame_bytes:(i + 1) * self.frame_bytes]
                for i in range(TOTAL_DAB_FRAMES)]


# ---- bitstream headers for export / codec init ----

_SAMPLE_RATE_INDEX = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4,
                      32000: 5, 24000: 6, 22050: 7, 16000: 8, 12000: 9,
                      11025: 10, 8000: 11}


def mpeg4_audio_specific_config(header: SuperFrameHeader) -> bytes:
    """AudioSpecificConfig for the DAB+ AAC stream (AAC-LC core, 960-sample
    frames, explicit SBR extension), mirroring the reference's hand-built
    bitstream (aac_audio_decoder.cpp:86-251)."""
    bits = []

    def put(v, n):
        for k in range(n - 1, -1, -1):
            bits.append((v >> k) & 1)

    core_rate = header.core_sample_rate
    put(2, 5)                                   # AAC-LC
    put(_SAMPLE_RATE_INDEX[core_rate], 4)
    put(2 if header.is_stereo else 1, 4)        # channel configuration
    put(1, 1)                                   # frameLengthFlag: 960 transform
    put(0, 1)                                   # dependsOnCoreCoder
    put(0, 1)                                   # extensionFlag
    if header.sbr:
        put(0x2B7, 11)                          # sync extension
        put(5, 5)                               # SBR object type
        put(1, 1)                               # SBR present
        put(_SAMPLE_RATE_INDEX[header.sampling_rate], 4)
    while len(bits) % 8:
        bits.append(0)
    return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8))


def adts_header(header: SuperFrameHeader, nb_au_bytes: int) -> bytes:
    """7-byte ADTS header for raw-AAC export (reference GetMPEG4Header;
    note DAB+ uses 960-sample frames which ADTS cannot express — players
    treat the stream as 1024, same caveat as the reference's exports)."""
    rate_idx = _SAMPLE_RATE_INDEX[header.core_sample_rate]
    channels = 2 if header.is_stereo else 1
    frame_len = nb_au_bytes + 7
    b = bytearray(7)
    b[0] = 0xFF
    b[1] = 0xF1                                  # MPEG-4, layer 0, no CRC
    b[2] = (1 << 6) | (rate_idx << 2) | ((channels >> 2) & 1)
    b[3] = ((channels & 0b11) << 6) | ((frame_len >> 11) & 0b11)
    b[4] = (frame_len >> 3) & 0xFF
    b[5] = ((frame_len & 0b111) << 5) | 0b11111
    b[6] = 0b11111100
    return bytes(b)
