"""FIG (Fast Information Group) binary parser.

ETSI EN 300 401 clause 5.2: each 32-byte FIB carries 30 data bytes of FIGs
(type 3b + length 5b headers) ending at a 0xFF delimiter. Parses the same
extension set as the reference (src/dab/fic/fig_processor.cpp, 1.8k LoC):
FIG 0/0,1,2,3,4,5,6,7,8,9,10,13,14,17,21,24 and FIG 1/0,1,4,5. Emits typed
event dataclasses consumed by the database updater (database.py).
"""

from dataclasses import dataclass, field
from typing import List, Optional

from .charsets import decode_label, abbreviated_label


# ------------- service / ensemble ids -------------

def parse_service_id(b: bytes) -> int:
    """32-bit (ECC+country+ref) or 16-bit (country+ref) service id."""
    if len(b) == 4:
        return (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
    return (b[0] << 8) | b[1]


def parse_ensemble_id(b: bytes) -> int:
    return (b[0] << 8) | b[1]


# ------------- event dataclasses (the FIC "schema") -------------

@dataclass
class EnsembleInfo:           # FIG 0/0
    ensemble_id: int
    change_flags: int
    alarm_flag: int
    cif_upper: int            # mod-20 counter
    cif_lower: int            # mod-250 counter


@dataclass
class SubchannelShort:        # FIG 0/1 short form (UEP)
    subchannel_id: int
    start_address: int
    table_switch: int
    table_index: int


@dataclass
class SubchannelLong:         # FIG 0/1 long form (EEP)
    subchannel_id: int
    start_address: int
    option: int               # 0 = type A, 1 = type B
    prot_level: int           # 0-based
    subchannel_size: int


@dataclass
class StreamComponent:        # FIG 0/2 tmid 00/01
    service_id: int
    subchannel_id: int
    is_audio: bool
    ty: int                   # ASCTy or DSCTy
    is_primary: bool


@dataclass
class PacketComponentRef:     # FIG 0/2 tmid 11
    service_id: int
    scid: int
    is_primary: bool


@dataclass
class PacketComponent:        # FIG 0/3
    scid: int
    subchannel_id: int
    dscty: int
    packet_address: int
    dg_flag: int


@dataclass
class StreamCA:               # FIG 0/4
    subchannel_id: int
    ca_org: int


@dataclass
class ComponentLanguage:      # FIG 0/5
    language: int
    subchannel_id: Optional[int] = None
    scid: Optional[int] = None


@dataclass
class ServiceLinkage:         # FIG 0/6
    is_active_link: bool
    is_hard_link: bool
    is_international: bool
    lsn: int
    service_ids: List[int] = field(default_factory=list)
    rds_pi_ids: List[int] = field(default_factory=list)
    drm_ids: List[int] = field(default_factory=list)
    has_id_list: bool = False


@dataclass
class ConfigurationInfo:      # FIG 0/7
    nb_services: int
    reconfiguration_count: int


@dataclass
class ComponentGlobalDefinition:  # FIG 0/8
    service_id: int
    scids: int
    subchannel_id: Optional[int] = None   # short form
    scid: Optional[int] = None            # long form


@dataclass
class EnsembleCountry:        # FIG 0/9
    lto: int
    ecc: int
    international_table_id: int
    service_ids: List[int] = field(default_factory=list)
    has_extension: bool = False   # reference emits only per-service
                                  # callbacks in the extended form


@dataclass
class DateTime:               # FIG 0/10
    mjd: int
    hours: int
    minutes: int
    seconds: int
    milliseconds: int
    lsi: int
    has_utc: int


@dataclass
class UserApplication:        # FIG 0/13
    service_id: int
    scids: int
    app_type: int
    app_data: bytes


@dataclass
class SubchannelFEC:          # FIG 0/14
    subchannel_id: int
    fec_scheme: int


@dataclass
class ProgrammeType:          # FIG 0/17
    service_id: int
    international_code: int
    language_type: int = 0
    cc_type: int = 0


@dataclass
class FrequencyInfo:          # FIG 0/21
    rm: int
    id_value: int
    frequency_hz: int
    is_continuous: bool
    geo_adjacent: bool = False      # rm=0 control field
    mode_one: bool = False          # rm=0 control field


@dataclass
class OtherEnsembleService:   # FIG 0/24
    service_id: int
    ensemble_id: int
    is_other_ensemble: bool


@dataclass
class Label:                  # FIG 1/x
    kind: str                 # 'ensemble' | 'service' | 'component'
    id_value: int
    label: str
    short_label: str
    scids: Optional[int] = None
    charset: int = 0


# ------------- parser -------------

class FIGParser:
    """Stateless FIB-to-event parser; call parse_fib per CRC-valid FIB."""

    def parse_fib(self, fib: bytes) -> list:
        events = []
        buf = bytes(fib)
        i, n = 0, len(buf)
        while i < n:
            header = buf[i]
            if header == 0xFF:       # end-of-FIGs delimiter
                break
            fig_type = (header >> 5) & 0b111
            data_len = header & 0b11111
            if i + 1 + data_len > n:
                break
            body = buf[i + 1: i + 1 + data_len]
            tail = buf[i + 1:]
            i += 1 + data_len
            if fig_type == 0:
                events += self._parse_type0(body, tail)
            elif fig_type == 1:
                events += self._parse_type1(body)
            elif fig_type in (2, 6):
                pass                  # unsupported in the reference too
            elif fig_type == 7:
                break
            else:
                break
        return events

    # ---- FIG type 0 ----

    def _parse_type0(self, buf: bytes, tail: bytes = b"") -> list:
        if not buf:
            return []
        cn = (buf[0] >> 7) & 1
        oe = (buf[0] >> 6) & 1
        pd = (buf[0] >> 5) & 1
        ext = buf[0] & 0b11111
        b = buf[1:]
        handler = getattr(self, f"_fig0_{ext}", None)
        if handler is None:
            return []
        return handler(b, pd=pd, oe=oe, cn=cn,
                       tail=(tail[1:] if tail else b))

    def _fig0_0(self, b, **kw):
        if len(b) != 4:      # reference requires the exact field length
            return []
        return [EnsembleInfo(parse_ensemble_id(b[:2]),
                             (b[2] >> 6) & 0b11, (b[2] >> 5) & 1,
                             b[2] & 0b11111, b[3])]

    def _fig0_1(self, b, **kw):
        out, i = [], 0
        while i + 3 <= len(b):
            sub_id = (b[i] >> 2) & 0b111111
            start = ((b[i] & 0b11) << 8) | b[i + 1]
            long_form = (b[i + 2] >> 7) & 1
            if not long_form:
                out.append(SubchannelShort(sub_id, start,
                                           (b[i + 2] >> 6) & 1,
                                           b[i + 2] & 0b111111))
                i += 3
            else:
                if i + 4 > len(b):
                    break
                out.append(SubchannelLong(sub_id, start,
                                          (b[i + 2] >> 4) & 0b111,
                                          (b[i + 2] >> 2) & 0b11,
                                          ((b[i + 2] & 0b11) << 8) | b[i + 3]))
                i += 4
        return out

    def _fig0_2(self, b, pd=0, **kw):
        out, i = [], 0
        sid_len = 4 if pd else 2
        while i < len(b):
            if i + sid_len + 1 > len(b):
                break
            sid = parse_service_id(b[i:i + sid_len])
            nb_comp = b[i + sid_len] & 0b1111
            j = i + sid_len + 1
            if j + 2 * nb_comp > len(b):
                break
            for k in range(nb_comp):
                b0, b1 = b[j + 2 * k], b[j + 2 * k + 1]
                tmid = (b0 >> 6) & 0b11
                if tmid in (0b00, 0b01):
                    out.append(StreamComponent(
                        sid, (b1 >> 2) & 0b111111, tmid == 0b00,
                        b0 & 0b111111, bool((b1 >> 1) & 1)))
                elif tmid == 0b11:
                    scid = ((b0 & 0b111111) << 6) | ((b1 >> 2) & 0b111111)
                    out.append(PacketComponentRef(sid, scid, bool((b1 >> 1) & 1)))
                else:
                    return out   # reserved TMId aborts the FIG (reference)
            i = j + 2 * nb_comp
        return out

    def _fig0_3(self, b, **kw):
        out, i = [], 0
        while i + 5 <= len(b):
            scid = (b[i] << 4) | ((b[i + 1] >> 4) & 0b1111)
            ca_org_flag = b[i + 1] & 1
            dg_flag = (b[i + 2] >> 7) & 1
            dscty = b[i + 2] & 0b111111
            sub_id = (b[i + 3] >> 2) & 0b111111
            addr = ((b[i + 3] & 0b11) << 8) | b[i + 4]
            need = 5 + (2 if ca_org_flag else 0)
            if i + need > len(b):   # CA-org field must fit (reference aborts)
                break
            out.append(PacketComponent(scid, sub_id, dscty, addr, dg_flag))
            i += need
        return out

    def _fig0_4(self, b, **kw):
        if len(b) % 3 != 0:  # reference aborts on partial entries
            return []
        out = []
        for i in range(0, len(b), 3):
            out.append(StreamCA(b[i] & 0b111111, (b[i + 1] << 8) | b[i + 2]))
        return out

    def _fig0_5(self, b, **kw):
        out, i = [], 0
        while i < len(b):
            long_form = (b[i] >> 7) & 1
            if not long_form:
                if i + 2 > len(b):
                    break
                out.append(ComponentLanguage(b[i + 1],
                                             subchannel_id=b[i] & 0b111111))
                i += 2
            else:
                if i + 3 > len(b):
                    break
                scid = ((b[i] & 0b1111) << 8) | b[i + 1]
                out.append(ComponentLanguage(b[i + 2], scid=scid))
                i += 3
        return out

    def _fig0_6(self, b, pd=0, **kw):
        """Mirrors fig_processor.cpp Ext_6 exactly, including its id-value
        compositions per (pd, international, IdLQ) — e.g. in the
        international 16-bit form the reference derives both the ECC and the
        sid high byte from the same entry byte."""
        out, i = [], 0
        while i + 2 <= len(b):
            id_list_flag = (b[i] >> 7) & 1
            link = ServiceLinkage(bool((b[i] >> 6) & 1), bool((b[i] >> 5) & 1),
                                  bool((b[i] >> 4) & 1),
                                  ((b[i] & 0b1111) << 8) | b[i + 1])
            if not id_list_flag:
                out.append(link)
                i += 2
                continue
            link.has_id_list = True
            if i + 3 > len(b):
                break
            idlq = (b[i + 2] >> 5) & 0b11
            nb_ids = b[i + 2] & 0b1111
            j = i + 3
            if len(b) - j <= 0:        # reference: empty list region aborts
                break
            if not pd and not link.is_international:
                step = 2
            elif not pd and link.is_international:
                step = 3
            else:
                step = 4
            if j + step * nb_ids > len(b):
                break
            for k in range(nb_ids):
                e = b[j + step * k: j + step * (k + 1)]
                if step == 2:
                    sid = rds = drm = (e[0] << 8) | e[1]
                elif step == 3:
                    sid = (e[0] << 16) | (e[0] << 8) | e[1]  # reference quirk
                    rds = (e[1] << 8) | e[2]
                    drm = (e[0] << 16) | (e[1] << 8) | e[2]
                else:
                    sid = drm = int.from_bytes(e, "big")
                    rds = (e[2] << 8) | e[3]
                if idlq == 0b00:
                    link.service_ids.append(sid)
                elif idlq == 0b01:
                    link.rds_pi_ids.append(rds)
                elif idlq == 0b11:
                    link.drm_ids.append(drm)
            out.append(link)
            i = j + step * nb_ids
        return out

    def _fig0_7(self, b, **kw):
        if len(b) != 2:      # reference requires the exact field length
            return []
        return [ConfigurationInfo((b[0] >> 2) & 0b111111,
                                  ((b[0] & 0b11) << 8) | b[1])]

    def _fig0_8(self, b, pd=0, **kw):
        out, i = [], 0
        sid_len = 4 if pd else 2
        while i < len(b):
            if i + sid_len + 2 > len(b):
                break
            sid = parse_service_id(b[i:i + sid_len])
            ext_flag = (b[i + sid_len] >> 7) & 1
            scids = b[i + sid_len] & 0b1111
            j = i + sid_len + 1
            ls_flag = (b[j] >> 7) & 1
            need = sid_len + 1 + (2 if ls_flag else 1) + (1 if ext_flag else 0)
            if i + need > len(b):   # reference aborts on a partial entry
                break
            if not ls_flag:
                out.append(ComponentGlobalDefinition(
                    sid, scids, subchannel_id=b[j] & 0b111111))
            else:
                out.append(ComponentGlobalDefinition(
                    sid, scids, scid=((b[j] & 0b1111) << 8) | b[j + 1]))
            i += need
        return out

    def _fig0_9(self, b, **kw):
        if len(b) < 3:
            return []
        ext_flag = (b[0] >> 7) & 1
        ev = EnsembleCountry(b[0] & 0b111111, b[1], b[2])
        nb_ext = len(b) - 3
        # reference: no-extension form must have no extra bytes; extended
        # form must have a nonempty extension (fig_processor.cpp Ext_9)
        if not ext_flag:
            return [ev] if nb_ext == 0 else []
        if nb_ext <= 0:
            return []
        ev.has_extension = True
        i = 3
        while i < len(b):
            if i + 2 > len(b):       # subfield header must fit
                break
            nb_services = (b[i] >> 6) & 0b11
            ecc = b[i + 1]
            j = i + 2
            if j + 2 * nb_services > len(b):
                break                # whole id list must fit (no partials)
            for k in range(nb_services):
                ev.service_ids.append(
                    (ecc << 16) | parse_service_id(b[j:j + 2]))
                j += 2
            i = j
        return [ev]

    def _fig0_10(self, b, **kw):
        if len(b) < 4:
            return []
        mjd = ((b[0] & 0b1111111) << 10) | (b[1] << 2) | ((b[2] >> 6) & 0b11)
        lsi = (b[2] >> 5) & 1
        utc = (b[2] >> 3) & 1
        hours = ((b[2] & 0b111) << 2) | ((b[3] >> 6) & 0b11)
        minutes = b[3] & 0b111111
        sec = ms = 0
        if utc:
            if len(b) < 6:   # reference aborts a truncated long form
                return []
            sec = (b[4] >> 2) & 0b111111
            ms = ((b[4] & 0b11) << 8) | b[5]
        return [DateTime(mjd, hours, minutes, sec, ms, lsi, utc)]

    def _fig0_13(self, b, pd=0, tail=None, **kw):
        """Mirrors the reference exactly (fig_processor.cpp Ext_13),
        including its quirk: the per-app remaining-bytes check is taken
        from the entity start, not the app list start, so app data may read
        up to header-size bytes past the declared FIG length (into the FIB
        tail)."""
        t = tail if tail is not None else b
        out, i = [], 0
        sid_len = 4 if pd else 2
        hdr = sid_len + 1
        N = len(b)
        while i != N and i < N:
            if hdr > N - i:
                break
            sid = parse_service_id(t[i:i + sid_len])
            scids = (t[i + sid_len] >> 4) & 0b1111
            nb_apps = t[i + sid_len] & 0b1111
            apps0 = i + hdr
            ai = 0
            ok = True
            for _ in range(nb_apps):
                app_remain = (N - i) - ai   # reference off-by-header quirk
                if 2 > app_remain or apps0 + ai + 2 > len(t):
                    ok = False
                    break
                a0, a1 = t[apps0 + ai], t[apps0 + ai + 1]
                app_type = (a0 << 3) | ((a1 >> 5) & 0b111)
                nb_data = a1 & 0b11111
                if 2 + nb_data > app_remain \
                        or apps0 + ai + 2 + nb_data > len(t):
                    ok = False
                    break
                out.append(UserApplication(
                    sid, scids, app_type,
                    bytes(t[apps0 + ai + 2: apps0 + ai + 2 + nb_data])))
                ai += 2 + nb_data
            if not ok:
                break
            i += hdr + ai
        return out

    def _fig0_14(self, b, **kw):
        return [SubchannelFEC((v >> 2) & 0b111111, v & 0b11) for v in b]

    def _fig0_17(self, b, **kw):
        out, i = [], 0
        while i + 4 <= len(b):
            sid = parse_service_id(b[i:i + 2])
            lang_flag = (b[i + 2] >> 5) & 1
            cc_flag = (b[i + 2] >> 4) & 1
            nb = 4 + lang_flag + cc_flag
            if i + nb > len(b):
                break
            j = i + 3
            lang = b[j] if lang_flag else 0
            j += lang_flag
            code = b[j] & 0b11111
            j += 1
            cc = b[j] if cc_flag else 0
            out.append(ProgrammeType(sid, code, lang, cc))
            i += nb
        return out

    def _fig0_21(self, b, tail=None, **kw):
        """Reference structure (fig_processor.cpp Ext_21): blocks of
        [rfa(11b) | fi_list_len(5b)] each containing FI lists of
        [id(16b) | rm(4b) | cont(1b) | nb_freq(3b) | freqs...]. The
        reference trusts the internal length fields beyond the declared FIG
        length (reads continue into the FIB tail) and aborts the whole FIG
        on inconsistent frequency-list lengths or unknown RM."""
        t = tail if tail is not None else b
        out, i = [], 0
        N = len(b)
        while i < N:
            if 2 > N - i:
                break
            nb_fi = t[i + 1] & 0b11111
            base = i + 2
            j = 0
            while j < nb_fi:
                if nb_fi - j < 3 or base + j + 3 > len(t):
                    return out
                idv = (t[base + j] << 8) | t[base + j + 1]
                rm = (t[base + j + 2] >> 4) & 0b1111
                cont = (t[base + j + 2] >> 3) & 1
                nb_freq = t[base + j + 2] & 0b111
                f0 = base + j + 3
                if f0 + nb_freq > len(t):
                    return out
                fl = t[f0: f0 + nb_freq]
                if rm == 0b0000:
                    if nb_freq % 3 != 0:
                        return out
                    for k in range(0, len(fl) - 2, 3):
                        # uint32 wrap matches the reference's arithmetic
                        # (only reachable for frequencies beyond any real
                        # DAB allocation)
                        freq = ((((fl[k] & 0b111) << 16) | (fl[k + 1] << 8)
                                 | fl[k + 2]) * 16000) & 0xFFFFFFFF
                        # reference byte-swaps the id when rebuilding the
                        # ensemble id (Ext_21 RM=0)
                        eid = ((idv & 0xFF) << 8) | (idv >> 8)
                        cf = (fl[k] >> 3) & 0b11111
                        out.append(FrequencyInfo(
                            rm, eid, freq, bool(cont),
                            geo_adjacent=not (cf & 1),
                            mode_one=bool(cf & 2)))
                elif rm == 0b1000:
                    for v in fl:
                        out.append(FrequencyInfo(rm, idv,
                                                 87500000 + v * 100000,
                                                 bool(cont)))
                elif rm == 0b0110:
                    if nb_freq % 3 != 0:
                        return out
                    for k in range(0, len(fl) - 2, 3):
                        raw = ((fl[k + 1] & 0b1111111) << 8) | fl[k + 2]
                        mult = 10000 if (fl[k + 1] >> 7) else 1000
                        out.append(FrequencyInfo(
                            rm, (fl[k] << 16) | idv, raw * mult, bool(cont)))
                elif rm == 0b1110:
                    if nb_freq % 3 != 0:
                        return out
                    for k in range(0, len(fl) - 2, 3):
                        raw = (fl[k + 1] << 8) | fl[k + 2]
                        out.append(FrequencyInfo(
                            rm, (fl[k] << 16) | idv, raw * 1000, bool(cont)))
                else:
                    return out        # unknown RM aborts the FIG
                j += 3 + nb_freq
            i += 2 + nb_fi
        return out

    def _fig0_24(self, b, pd=0, oe=0, **kw):
        out, i = [], 0
        sid_len = 4 if pd else 2
        while i < len(b):
            if i + sid_len + 1 > len(b):
                break
            sid = parse_service_id(b[i:i + sid_len])
            nb_eids = b[i + sid_len] & 0b1111
            j = i + sid_len + 1
            if j + 2 * nb_eids > len(b):
                break
            for k in range(nb_eids):
                eid = parse_ensemble_id(b[j + 2 * k: j + 2 * k + 2])
                out.append(OtherEnsembleService(sid, eid, bool(oe)))
            i = j + 2 * nb_eids
        return out

    # ---- FIG type 1 (labels) ----

    def _parse_type1(self, buf: bytes) -> list:
        if not buf:
            return []
        charset = (buf[0] >> 4) & 0b1111
        ext = buf[0] & 0b111
        b = buf[1:]

        def mk(kind, idv, body, scids=None):
            label_b, flags = body[:16], (body[16] << 8) | body[17]
            return Label(kind, idv, decode_label(label_b, charset).rstrip(),
                         abbreviated_label(label_b, flags, charset).rstrip(),
                         scids, charset)

        if ext == 0 and len(b) == 20:
            return [mk("ensemble", parse_ensemble_id(b[:2]), b[2:])]
        if ext == 1 and len(b) == 20:
            return [mk("service", parse_service_id(b[:2]), b[2:])]
        if ext == 5 and len(b) == 22:
            return [mk("service", parse_service_id(b[:4]), b[4:])]
        if ext == 4 and len(b) >= 1:
            pd = (b[0] >> 7) & 1
            scids = b[0] & 0b1111
            sid_len = 4 if pd else 2
            if len(b) == 1 + sid_len + 18:
                return [mk("component", parse_service_id(b[1:1 + sid_len]),
                           b[1 + sid_len:], scids)]
        return []
