"""AAC-LC raw_data_block bitstream walker (ISO/IEC 14496-3 clause 4.4).

The DAB+ SBR payload rides in a fill element *after* the audio element, and
AAC elements are not self-delimiting — locating the fill element requires
parsing everything before it, including Huffman-coded spectral data. The
reference delegates this to its vendored faad2 (src/dab/audio/
aac_audio_decoder.cpp:328-350); here we walk the bitstream ourselves so the
SBR payload can be split out for the SBR stage while the system
libavcodec decodes the stripped AAC-LC core (which it supports at 960).

Walks: SCE/CPE/LFE (full individual_channel_stream incl. section data,
scalefactors, pulse/TNS, spectral Huffman with codebook-11 escapes, PNS,
intensity stereo), DSE, FIL (capturing EXT_SBR_DATA payloads), PCE, END.
CCE (channel coupling) is not supported — not used by DAB+ encoders; a
walker error makes the caller fall back to whole-AU core decode.
"""

from dataclasses import dataclass, field
from typing import List, Optional

from .bits import BitReader, BitWriter
from . import aac_tables as T

# syntactic element ids
SCE, CPE, CCE, LFE, DSE, PCE, FIL, END = range(8)
EXT_FILL, EXT_FILL_DATA, EXT_DATA_ELEMENT = 0, 1, 2
EXT_DYNAMIC_RANGE = 11
EXT_SBR_DATA, EXT_SBR_DATA_CRC = 13, 14

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = range(4)


class WalkError(ValueError):
    pass


@dataclass
class Element:
    etype: int
    tag: int
    bit_start: int
    bit_end: int = 0


@dataclass
class SBRPayload:
    """One EXT_SBR_DATA(_CRC) extension: raw payload bits as read off the
    fill element (starting at bs_sbr_crc_bits/bs_header_flag)."""
    data: bytes          # payload bits, MSB-first, zero-padded
    nbits: int
    has_crc: bool
    for_element: int     # etype of the preceding audio element (SCE/CPE)


@dataclass
class WalkResult:
    elements: List[Element] = field(default_factory=list)
    sbr: List[SBRPayload] = field(default_factory=list)
    end_bit: int = 0     # bit position just after END

    @property
    def has_sbr(self) -> bool:
        return bool(self.sbr)


def _copy_bits(src: bytes, a: int, b: int, bw: BitWriter):
    br = BitReader(src, a)
    n = b - a
    while n >= 24:
        bw.write(br.read(24), 24)
        n -= 24
    if n:
        bw.write(br.read(n), n)


class RawDataBlockWalker:
    """Configured for one (sampling_index, frame_length) pair."""

    def __init__(self, sampling_index: int, frame_len: int = 960):
        self.sampling_index = sampling_index
        self.frame_len = frame_len
        self.swb_long = T.swb_offsets(sampling_index, frame_len)
        self.num_swb_long = T.num_swb(sampling_index, frame_len)
        short_len = 120 if frame_len == 960 else 128
        self.swb_short = T.swb_offsets(sampling_index, short_len)
        self.num_swb_short = T.num_swb(sampling_index, short_len)

    # ---- public API ----

    def walk(self, au: bytes) -> WalkResult:
        br = BitReader(au)
        res = WalkResult()
        last_audio = None
        while True:
            start = br.pos
            etype = br.read(3)
            if etype == END:
                res.end_bit = br.pos
                break
            if etype == FIL:
                self._fill(br, res, last_audio)
                res.elements.append(Element(FIL, 0, start, br.pos))
                continue
            tag = br.read(4)
            if etype in (SCE, LFE):
                self._ics(br, common_window=False)
                last_audio = etype
            elif etype == CPE:
                self._cpe(br)
                last_audio = etype
            elif etype == DSE:
                self._dse(br)
            elif etype == PCE:
                self._pce(br)
            else:
                raise WalkError(f"unsupported element type {etype}")
            res.elements.append(Element(etype, tag, start, br.pos))
        return res

    def strip_sbr(self, au: bytes, walk: Optional[WalkResult] = None) -> bytes:
        """Re-serialize the AU with SBR fill elements removed — the AAC-LC
        core stream libavcodec can decode at 960."""
        w = walk or self.walk(au)
        bw = BitWriter()
        for el in w.elements:
            if el.etype == FIL and self._is_sbr_fill(au, el):
                continue
            _copy_bits(au, el.bit_start, el.bit_end, bw)
        bw.write(END, 3)
        bw.align()
        return bw.tobytes()

    def _is_sbr_fill(self, au: bytes, el: Element) -> bool:
        """True if ANY extension_payload in this FIL is SBR (it may sit
        after a data-element/DRC extension)."""
        class _Probe:
            sbr = None
        probe = _Probe()
        probe.sbr = []
        br = BitReader(au, el.bit_start)
        br.skip(3)
        try:
            self._fill(br, probe, last_audio=None)
        except Exception:
            return False
        return bool(probe.sbr)

    # ---- element parsers ----

    def _fill(self, br: BitReader, res: WalkResult, last_audio):
        cnt = br.read(4)
        if cnt == 15:
            cnt += br.read(8) - 1
        end = br.pos + 8 * cnt
        while br.pos < end:
            self._extension_payload(br, end - br.pos, res, last_audio)
        if br.pos != end:
            raise WalkError("fill element overrun")

    def _extension_payload(self, br: BitReader, nbits: int, res, last_audio):
        """Parse one extension_payload with its spec length so an
        EXT_SBR_DATA is found at any position within a FIL, even after a
        data-element or DRC extension (round-2 ADVICE: consuming the whole
        fill for any non-SBR type silently dropped trailing SBR)."""
        ext = br.read(4)
        if ext in (EXT_SBR_DATA, EXT_SBR_DATA_CRC):
            payload_bits = nbits - 4
            bw = BitWriter()
            rem = payload_bits
            while rem >= 16:
                bw.write(br.read(16), 16)
                rem -= 16
            if rem:
                bw.write(br.read(rem), rem)
            res.sbr.append(SBRPayload(bw.tobytes(), payload_bits,
                                      ext == EXT_SBR_DATA_CRC, last_audio))
        elif ext == EXT_DATA_ELEMENT:
            # data_element_version(4); v0 has an explicit byte length —
            # consume exactly it so later extensions in this FIL survive
            if br.read(4) == 0:
                ln = 0
                while True:
                    part = br.read(8)
                    ln += part
                    if part != 255:
                        break
                br.skip(8 * ln)
            else:
                br.skip(nbits - 8)
        elif ext == EXT_DYNAMIC_RANGE:
            self._dynamic_range_info(br)
        else:
            # EXT_FILL / EXT_FILL_DATA / unknown: pads the remainder
            br.skip(nbits - 4)

    @staticmethod
    def _dynamic_range_info(br: BitReader):
        """dynamic_range_info() (ISO 14496-3 4.5.2.7): definite length."""
        drc_num_bands = 1
        if br.read1():                     # pce instance tag present
            br.skip(8)
        if br.read1():                     # excluded channels present
            while True:
                br.skip(7)
                if not br.read1():
                    break
        if br.read1():                     # band info present
            drc_num_bands += br.read(4)
            br.skip(4)                     # interpolation scheme
            br.skip(8 * drc_num_bands)     # band tops
        if br.read1():                     # prog ref level present
            br.skip(8)
        br.skip(8 * drc_num_bands)         # dyn_rng_sgn/ctl per band

    def _dse(self, br: BitReader):
        byte_align = br.read1()
        cnt = br.read(8)
        if cnt == 255:
            cnt += br.read(8)
        if byte_align:
            br.align()
        br.skip(8 * cnt)

    def _pce(self, br: BitReader):
        br.skip(2 + 4)                     # object type, sampling idx
        nfront = br.read(4)
        nside = br.read(4)
        nback = br.read(4)
        nlfe = br.read(2)
        ndata = br.read(3)
        ncc = br.read(4)
        if br.read1():
            br.skip(4)                     # mono mixdown
        if br.read1():
            br.skip(4)                     # stereo mixdown
        if br.read1():
            br.skip(3)                     # matrix mixdown
        br.skip(5 * (nfront + nside + nback) + 4 * nlfe + 4 * ndata + 5 * ncc)
        br.align()
        br.skip(8 * br.read(8))            # comment field

    def _cpe(self, br: BitReader):
        common = br.read1()
        if common:
            info = self._ics_info(br)
            ms_mask = br.read(2)
            if ms_mask == 1:
                br.skip(info["num_window_groups"] * info["max_sfb"])
            elif ms_mask == 3:
                raise WalkError("reserved ms_mask_present")
            self._ics(br, common_window=True, shared_info=info)
            self._ics(br, common_window=True, shared_info=info)
        else:
            self._ics(br, common_window=False)
            self._ics(br, common_window=False)

    def _ics_info(self, br: BitReader) -> dict:
        br.read1()                         # ics_reserved_bit
        window_sequence = br.read(2)
        br.read1()                         # window_shape
        if window_sequence == EIGHT_SHORT:
            max_sfb = br.read(4)
            grouping = br.read(7)
            groups = [1]
            for b in range(6, -1, -1):
                if (grouping >> b) & 1:
                    groups[-1] += 1
                else:
                    groups.append(1)
            num_swb = self.num_swb_short
            offsets = self.swb_short
        else:
            max_sfb = br.read(6)
            if br.read1():                 # predictor_data_present
                raise WalkError("prediction not allowed in AAC-LC")
            groups = [1]
            num_swb = self.num_swb_long
            offsets = self.swb_long
        if max_sfb > num_swb:
            raise WalkError(f"max_sfb {max_sfb} > num_swb {num_swb}")
        return {
            "window_sequence": window_sequence,
            "max_sfb": max_sfb,
            "num_window_groups": len(groups),
            "group_sizes": groups,
            "swb_offsets": offsets,
        }

    def _ics(self, br: BitReader, common_window: bool, shared_info=None):
        br.skip(8)                         # global_gain
        info = shared_info if common_window else self._ics_info(br)
        cbs = self._section_data(br, info)
        self._scale_factor_data(br, info, cbs)
        if br.read1():                     # pulse_data_present
            if info["window_sequence"] == EIGHT_SHORT:
                raise WalkError("pulse data with short windows")
            npulse = br.read(2)
            br.skip(6)                     # pulse_start_sfb
            br.skip((npulse + 1) * (5 + 4))
        if br.read1():                     # tns_data_present
            self._tns_data(br, info)
        if br.read1():                     # gain_control_data_present
            raise WalkError("SSR gain control in LC stream")
        self._spectral_data(br, info, cbs)

    def _section_data(self, br: BitReader, info) -> list:
        """Returns [(group, sfb)] -> codebook as a per-group list."""
        bits = 3 if info["window_sequence"] == EIGHT_SHORT else 5
        esc = (1 << bits) - 1
        out = []
        for g in range(info["num_window_groups"]):
            row = []
            k = 0
            while k < info["max_sfb"]:
                cb = br.read(4)
                if cb == 12:
                    raise WalkError("reserved codebook 12")
                length = 0
                while True:
                    inc = br.read(bits)
                    length += inc
                    if inc != esc:
                        break
                if length == 0 or k + length > info["max_sfb"]:
                    raise WalkError("bad section length")
                row.extend([cb] * length)
                k += length
            out.append(row)
        return out

    def _scale_factor_data(self, br: BitReader, info, cbs):
        sf_huff = T.scalefactor_huffman()
        noise_seen = False
        for g in range(info["num_window_groups"]):
            for sfb in range(info["max_sfb"]):
                cb = cbs[g][sfb]
                if cb == 0:
                    continue
                if cb in T.INTENSITY_CB:
                    sf_huff.decode(br)
                elif cb == T.NOISE_CB:
                    if not noise_seen:
                        noise_seen = True
                        br.skip(9)
                    else:
                        sf_huff.decode(br)
                else:
                    sf_huff.decode(br)

    def _tns_data(self, br: BitReader, info):
        short = info["window_sequence"] == EIGHT_SHORT
        n_windows = sum(info["group_sizes"]) if short else 1
        nfilt_bits = 1 if short else 2
        len_bits = 4 if short else 6
        order_bits = 3 if short else 5
        for _ in range(n_windows):
            n_filt = br.read(nfilt_bits)
            if n_filt:
                coef_res = br.read1()
            for _ in range(n_filt):
                br.skip(len_bits)
                order = br.read(order_bits)
                if order:
                    br.read1()             # direction
                    compress = br.read1()
                    coef_bits = coef_res + 3 - compress
                    br.skip(order * coef_bits)

    def _spectral_data(self, br: BitReader, info, cbs):
        offsets = info["swb_offsets"]
        for g, gsize in enumerate(info["group_sizes"]):
            for sfb in range(info["max_sfb"]):
                cb = cbs[g][sfb]
                if cb == 0 or cb >= T.NOISE_CB:
                    continue
                width = (int(offsets[sfb + 1]) - int(offsets[sfb])) * gsize
                self._decode_band(br, cb, width)

    def _decode_band(self, br: BitReader, cb: int, width: int):
        dim, signed, lav = T.SPECTRAL_CB[cb]
        huff = T.spectral_huffman(cb)
        base = lav + 1
        for _ in range(0, width, dim):
            idx = huff.decode(br)
            if signed:
                continue                   # offset-encoded, no sign bits
            # unsigned books: magnitudes packed base-(LAV+1), MSB-first
            vals = []
            rem = idx
            for _ in range(dim):
                vals.append(rem % base)
                rem //= base
            vals.reverse()
            # all sign bits for the tuple first, then escape sequences
            for v in vals:
                if v:
                    br.read1()
            if cb == T.ESC_CB:
                for v in vals:
                    if v == 16:
                        n = 4
                        while br.read1():
                            n += 1
                            if n > 24:
                                raise WalkError("escape prefix too long")
                        br.skip(n)         # escape word
