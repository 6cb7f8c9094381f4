"""Parametric stereo (HE-AAC v2) bitstream layer (ISO/IEC 14496-3 8.6.4).

DAB+ services can signal PS in the superframe header (TS 102 563 table 4).
The PS payload rides inside the SBR extension (bs_extension_id == 2); this
module parses it completely — header, envelope grid, IID/ICC/IPD/OPD
parameter sets with delta-time/delta-freq Huffman coding — and provides the
matching writer for closed-loop tests. Huffman tables are the ISO spec
constants extracted from the system libavcodec archive (aacps_common.o).

Reconstruction: decoded parameters feed dab.ps_synth, which rebuilds true
stereo in the QMF domain (20-band, 34-band and mixed-resolution configs,
differentially validated against libavcodec's HE-AAC v2 decode).
"""

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .bits import BitReader, BitWriter, Huffman
from . import aac_tables as T


def _huff(name: str) -> Huffman:
    return T.sbr_huffman_raw(f"ps_huff_{name}")


# number of parameters per iid/icc mode (modes 0-5; 3-5 are fine/34-band;
# 6-7 are reserved — corrupted streams must fail as a parse error, not an
# index crash)
def nr_par(mode: int) -> int:
    if not 0 <= mode <= 5:
        raise ValueError(f"reserved PS iid/icc mode {mode}")
    return int(T._npz()["ps_nr_iidicc_par_tab"][mode])


@dataclass
class PSData:
    enable_iid: bool = False
    iid_mode: int = 0
    enable_icc: bool = False
    icc_mode: int = 0
    enable_ext: bool = False
    frame_class: int = 0
    num_env: int = 0
    border_position: List[int] = field(default_factory=list)
    iid_par: Optional[np.ndarray] = None    # (num_env, nr_iid_par) indices
    icc_par: Optional[np.ndarray] = None
    ipd_par: Optional[np.ndarray] = None
    opd_par: Optional[np.ndarray] = None
    enable_ipdopd: bool = False


class PSBitstream:
    """Stateful parser: carries header config + previous-envelope parameter
    rows for delta-time decoding across frames."""

    def __init__(self, num_time_slots: int = 32):
        self.nts = num_time_slots
        self.cfg: Optional[PSData] = None
        self.prev_iid = None
        self.prev_icc = None
        self.prev_ipd = None
        self.prev_opd = None

    def parse(self, br: BitReader) -> PSData:
        d = PSData()
        if br.read1():                       # enable_ps_header
            d.enable_iid = bool(br.read1())
            if d.enable_iid:
                d.iid_mode = br.read(3)
            d.enable_icc = bool(br.read1())
            if d.enable_icc:
                d.icc_mode = br.read(3)
            d.enable_ext = bool(br.read1())
            self.cfg = d
        elif self.cfg is not None:
            d.enable_iid = self.cfg.enable_iid
            d.iid_mode = self.cfg.iid_mode
            d.enable_icc = self.cfg.enable_icc
            d.icc_mode = self.cfg.icc_mode
            d.enable_ext = self.cfg.enable_ext

        d.frame_class = br.read1()
        num_env_idx = br.read(2)
        d.num_env = int(T._npz()["ps_num_env_tab"][
            (d.frame_class << 2) | num_env_idx])
        if d.frame_class:
            d.border_position = [br.read(5) for _ in range(d.num_env)]
        else:
            d.border_position = [
                (e + 1) * self.nts // max(d.num_env, 1) - 1
                for e in range(d.num_env)]

        if d.enable_iid:
            fine = d.iid_mode > 2
            n = nr_par(d.iid_mode)
            rows = []
            prev = self.prev_iid if self.prev_iid is not None \
                and len(self.prev_iid) == n else np.zeros(n, np.int64)
            for _ in range(d.num_env):
                dt = br.read1()
                rows.append(self._pars(
                    br, n, dt, prev,
                    _huff("iid_dt1" if fine else "iid_dt0"),
                    _huff("iid_df1" if fine else "iid_df0")))
                prev = rows[-1]
            d.iid_par = np.stack(rows) if rows else None
            if rows:
                self.prev_iid = rows[-1]
        if d.enable_icc:
            n = nr_par(d.icc_mode)
            rows = []
            prev = self.prev_icc if self.prev_icc is not None \
                and len(self.prev_icc) == n else np.zeros(n, np.int64)
            for _ in range(d.num_env):
                dt = br.read1()
                rows.append(self._pars(br, n, dt, prev,
                                       _huff("icc_dt"), _huff("icc_df")))
                prev = rows[-1]
            d.icc_par = np.stack(rows) if rows else None
            if rows:
                self.prev_icc = rows[-1]
        if d.enable_ext:
            cnt = br.read(4)
            if cnt == 15:
                cnt += br.read(8)
            end = br.pos + 8 * cnt
            while br.pos + 7 < end:
                ext_id = br.read(2)
                if ext_id == 0:              # ipdopd data
                    d.enable_ipdopd = bool(br.read1())
                    if d.enable_ipdopd:
                        n = int(T._npz()["ps_nr_iidopd_par_tab"][d.iid_mode])
                        ipd, opd = [], []
                        # like iid/icc above: a stale prev row from a
                        # different band resolution (iid_mode switch)
                        # must reset, not index-crash a dt row
                        prev_i = self.prev_ipd if self.prev_ipd is not None \
                            and len(self.prev_ipd) == n \
                            else np.zeros(n, np.int64)
                        prev_o = self.prev_opd if self.prev_opd is not None \
                            and len(self.prev_opd) == n \
                            else np.zeros(n, np.int64)
                        for _ in range(d.num_env):
                            dt = br.read1()
                            ipd.append(self._pars(
                                br, n, dt, prev_i,
                                _huff("ipd_dt"), _huff("ipd_df"), mod=8))
                            prev_i = ipd[-1]
                            dt = br.read1()
                            opd.append(self._pars(
                                br, n, dt, prev_o,
                                _huff("opd_dt"), _huff("opd_df"), mod=8))
                            prev_o = opd[-1]
                        d.ipd_par = np.stack(ipd)
                        d.opd_par = np.stack(opd)
                        self.prev_ipd = prev_i
                        self.prev_opd = prev_o
                else:
                    break
            br.pos = min(end, br.nbits)
        return d

    @staticmethod
    def _pars(br, n, dt, prev, huff_dt, huff_df, mod=None):
        offset = 0 if mod else _huff_offset(huff_df)
        row = np.zeros(n, np.int64)
        if dt:
            for b in range(n):
                row[b] = prev[b] + huff_dt.decode(br) - offset
        else:
            acc = 0
            for b in range(n):
                acc = acc + huff_df.decode(br) - offset
                row[b] = acc
        if mod:
            row %= mod
        return row


def _huff_offset(h: Huffman) -> int:
    return (len(h.codes) - 1) // 2


def write_ps_data(bw: BitWriter, d: PSData, nts: int = 32,
                  send_header: bool = True):
    """Serialize one PS frame (delta-freq coding; FIX grid, or VAR when
    d.frame_class=1 with explicit d.border_position end slots)."""
    want_ext = d.enable_ipdopd and d.ipd_par is not None
    bw.write(1 if send_header else 0, 1)
    if send_header:
        bw.write(int(d.enable_iid), 1)
        if d.enable_iid:
            bw.write(d.iid_mode, 3)
        bw.write(int(d.enable_icc), 1)
        if d.enable_icc:
            bw.write(d.icc_mode, 3)
        bw.write(int(want_ext), 1)           # enable_ext (ipdopd rides it)
    bw.write(d.frame_class, 1)
    num_env_tab = T._npz()["ps_num_env_tab"]
    base = 4 * d.frame_class
    idx = [i for i in range(4)
           if num_env_tab[base + i] == d.num_env][0]
    bw.write(idx, 2)
    if d.frame_class:
        for b in d.border_position[:d.num_env]:
            bw.write(int(b), 5)

    def pars(rows, huff_df, huff_dt, dts=None, prev=None):
        off_f = _huff_offset(huff_df)
        off_t = _huff_offset(huff_dt)
        last = prev
        for e, row in enumerate(rows):
            dt = bool(dts[e]) if dts is not None else False
            bw.write(1 if dt else 0, 1)
            if dt:
                assert last is not None, "dt=1 needs a previous row"
                for a, b in zip(last, row):
                    huff_dt.encode(bw, int(b) - int(a) + off_t)
            else:
                acc = 0
                for v in row:
                    huff_df.encode(bw, int(v) - acc + off_f)
                    acc = int(v)
            last = row

    if d.enable_iid:
        fine = d.iid_mode > 2
        pars(d.iid_par, _huff("iid_df1" if fine else "iid_df0"),
             _huff("iid_dt1" if fine else "iid_dt0"),
             getattr(d, "iid_dt", None), getattr(d, "prev_iid", None))
    if d.enable_icc:
        pars(d.icc_par, _huff("icc_df"), _huff("icc_dt"),
             getattr(d, "icc_dt", None), getattr(d, "prev_icc", None))
    if not want_ext and not send_header and d.enable_ext:
        # headerless frame under a persistent enable_ext config: the
        # parser WILL read an extension length, so emit an empty one
        # (cnt=0) instead of desyncing the payload
        bw.write(0, 4)
    if want_ext:
        if not send_header and not d.enable_ext:
            raise ValueError(
                "ipd/opd on a headerless frame needs enable_ext=True in "
                "the stream's last header frame (the parser only reads "
                "the extension length under that config)")
        # ipdopd extension (ext id 0): per envelope an ipd row then an opd
        # row, delta-freq or delta-time coded modulo 8 (offset-free
        # huffman, mirrors PSBitstream.parse's mod=8 path)
        ext = BitWriter()
        ext.write(0, 2)
        ext.write(1, 1)                      # enable_ipdopd
        streams = ((d.ipd_par, getattr(d, "ipd_dt", None),
                    getattr(d, "prev_ipd", None),
                    _huff("ipd_dt"), _huff("ipd_df")),
                   (d.opd_par, getattr(d, "opd_dt", None),
                    getattr(d, "prev_opd", None),
                    _huff("opd_dt"), _huff("opd_df")))
        for e in range(len(d.ipd_par)):
            for rows, dts, prev, hdt, hdf in streams:
                row = rows[e]
                dt = bool(dts[e]) if dts is not None else False
                ext.write(1 if dt else 0, 1)
                if dt:
                    last = prev if e == 0 else rows[e - 1]
                    assert last is not None, "dt=1 needs a previous row"
                    for a, b in zip(last, row):
                        hdt.encode(ext, (int(b) - int(a)) % 8)
                else:
                    acc = 0
                    for v in row:
                        hdf.encode(ext, (int(v) - acc) % 8)
                        acc = int(v)
        nbytes = (len(ext) + 7) // 8
        if nbytes >= 15:
            bw.write(15, 4)
            bw.write(nbytes - 15, 8)
        else:
            bw.write(nbytes, 4)
        bw.extend(ext)
        bw.write(0, 8 * nbytes - len(ext))
