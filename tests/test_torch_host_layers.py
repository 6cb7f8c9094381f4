"""The port's own host layers against their originals in the JAX package.

``dab_radio_tpu_torch`` keeps numpy and ctypes copies of the JAX package's
host modules (parameter tables, CRC/scrambler/RS/QMF, FIG and database, the
DAB+ audio and data protocols, IO and codecs), so that it imports nothing of
``dab_radio_tpu``. Every copied module is held here against its original on
the same inputs, made from a seed with numpy or by the port's transmitter.
Tolerance: exact everywhere, the float audio synthesis (QMF, SBR, PS)
included, since both sides run the same numpy code.
"""

import dataclasses
import enum
import importlib
import io
import types

import numpy as np
import pytest

from dab_radio_tpu.models import pad_writer            # TX-side PAD/MOT builders

COPIED = [
    "params", "params.ofdm", "params.prs", "params.mapper", "params.puncture",
    "params.protection", "params.tables",
    "ops.crc", "ops.scrambler", "ops.qmf", "ops.rs",
    "dab.bits", "dab.charsets", "dab.fig", "dab.fig_native", "dab.database",
    "dab.aac_tables", "dab.aac_bits", "dab.aac", "dab.aac_data", "dab.aac_enc",
    "dab.sbr", "dab.ps", "dab.ps_synth", "dab.mp2", "dab.pad", "dab.mot",
    "dab.slideshow", "dab.packets",
    "host.native", "host.io", "host.codecs", "host.audio", "host.scraper",
    "host.device", "models.channel", "models.pad_writer",
]
# names one side has and the other rightly lacks
ONLY_JAX = {"dab.aac": {"_read_au_starts", "crc16_ragged"},
            "ops.crc": {"crc16_ragged"}}
ONLY_PORT = {"host.native": {"native_status"},
             # the batched superframe finish: its counter and tables
             "dab.aac": {"SF_STATS", "_parse_header",
                         "_finish_tables", "_HEADERS", "_PARTS", "_PAST_AUS",
                         "_AU_RESIDUE", "_PARTS_ROW", "_EVEN", "_RS_FAILED",
                         "crc16_bounds", "crc16_batch", "_crc16_table"},
             "ops.crc": {"crc16_bounds", "_pointer", "_crc16_table_address",
                         "ctypes"},
             "host.io": {"profile_scope"},       # the span io/convert
             # the decoder's counters and its device stage's constants
             "ops.rs": {"RS_STATS", "syndrome_constants",
                        "_SYNDROME_CONSTANTS"}}


def both(name):
    """(module of the JAX package, its copy in the port)."""
    return (importlib.import_module(f"dab_radio_tpu.{name}"),
            importlib.import_module(f"dab_radio_tpu_torch.{name}"))


_PLAIN = (int, float, complex, str, bytes, bool, type(None))


def assert_same(a, b, where="value"):
    """Deep equality of plain data, numpy arrays and objects of the two
    packages' (distinct but equally named) classes."""
    if isinstance(a, (np.ndarray, np.generic)):
        assert isinstance(b, (np.ndarray, np.generic)), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, enum.Enum):
        assert a.name == b.name and a.value == b.value, where
    elif isinstance(a, _PLAIN):
        assert type(a) is type(b) and a == b, f"{where}: {a!r} != {b!r}"
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple, set, frozenset)) or \
            type(a).__name__ == "deque":
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b), where
        if isinstance(a, (set, frozenset)):
            a, b = sorted(a), sorted(b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif callable(a) or isinstance(a, types.ModuleType):
        assert callable(b) or isinstance(b, types.ModuleType), where
    else:
        assert type(a).__name__ == type(b).__name__, where
        if dataclasses.is_dataclass(a):
            fields = [f.name for f in dataclasses.fields(a)]
            assert fields == [f.name for f in dataclasses.fields(b)], where
        else:
            names = lambda o: sorted(getattr(o, "__slots__", None) or vars(o))
            fields = names(a)
            assert fields == names(b), where
        for k in fields:
            va, vb = getattr(a, k), getattr(b, k)
            if type(va).__module__.startswith("ctypes") or \
                    type(va).__name__ in ("CDLL", "lock", "RLock"):
                continue
            assert_same(va, vb, f"{where}.{k}")


def _is_data(v):
    if isinstance(v, (np.ndarray, np.generic, enum.Enum) + _PLAIN):
        return True
    if isinstance(v, dict):
        return all(_is_data(k) and _is_data(x) for k, x in v.items())
    if isinstance(v, (list, tuple, set, frozenset)):
        return all(_is_data(x) for x in v)
    return dataclasses.is_dataclass(v) and not isinstance(v, type)


@pytest.mark.parametrize("name", COPIED)
def test_module_names_and_constants_match(name):
    """Same public names on both sides, and every module-level constant
    (tables, tuples, dicts, numbers) equal."""
    j, t = both(name)
    public = lambda m: {k for k in vars(m) if not k.startswith("__")}
    assert public(j) - public(t) == ONLY_JAX.get(name, set())
    assert public(t) - public(j) == ONLY_PORT.get(name, set())
    for k, v in vars(j).items():
        if k.startswith("__") or not _is_data(v):
            continue
        if isinstance(v, str) and "dab_radio_tpu" in v:
            continue                       # a path inside the package itself
        assert_same(v, getattr(t, k), f"{name}.{k}")
    assert not {"jax", "jnp"} & set(vars(t)), name


# ------------------------------------------------------------------ params

@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_ofdm_tables_match(mode):
    j, t = both("params")
    jm, tm = both("params.mapper")
    pj, pt = j.get_ofdm_params(mode), t.get_ofdm_params(mode)
    assert_same(pj, pt, "ofdm params")
    assert_same(j.get_dab_params(mode), t.get_dab_params(mode), "dab params")
    for prop in ("nb_cyclic_prefix", "nb_frame_samples", "nb_data_symbols",
                 "nb_frame_bits"):
        assert getattr(pj, prop) == getattr(pt, prop)
    for prop in ("nb_sym_bits", "nb_fic_bits", "nb_msc_bits", "nb_fib_bits",
                 "nb_fib_cif_bits", "nb_cif_bits"):
        assert getattr(j.get_dab_params(mode), prop) == \
            getattr(t.get_dab_params(mode), prop)
    assert_same(j.get_prs_reference(mode), t.get_prs_reference(mode), "prs")
    args = (pj.nb_fft, pj.nb_data_carriers)
    for fn in ("get_carrier_mapper", "get_inverse_carrier_mapper",
               "get_carrier_to_fft_bin"):
        assert_same(getattr(jm, fn)(*args), getattr(tm, fn)(*args), fn)


def test_puncture_vectors_and_fic_schedule_match():
    j, t = both("params.puncture")
    for pi in range(1, 25):
        assert_same(j.get_puncture_vector(pi), t.get_puncture_vector(pi),
                    f"PI {pi}")
    assert_same(j.PI_X_VECTOR, t.PI_X_VECTOR, "PI_X")
    sj, st = j.fic_puncture_schedule(), t.fic_puncture_schedule()
    assert_same(sj, st, "fic schedule")
    assert_same(j.build_puncture_mask(sj), t.build_puncture_mask(st), "mask")
    assert_same(j.build_depuncture_gather(sj), t.build_depuncture_gather(st),
                "gather")


def _assert_msc_schedule_same(cfg_fields):
    j, t = both("params")
    jp, tp = both("params.puncture")
    cj, ct = j.SubchannelConfig(**cfg_fields), t.SubchannelConfig(**cfg_fields)
    assert cj.nb_cif_bits == ct.nb_cif_bits
    assert cj.bitrate_kbps() == ct.bitrate_kbps()
    sj, st = j.msc_puncture_schedule(cj), t.msc_puncture_schedule(ct)
    assert_same(sj, st, "msc schedule")
    assert_same(jp.build_depuncture_gather(sj), tp.build_depuncture_gather(st),
                "gather")


@pytest.mark.parametrize("index", range(64))
def test_uep_schedules_match(index):
    j, t = both("params.protection")
    assert_same(j.get_uep_profile(index), t.get_uep_profile(index), "profile")
    prof = j.get_uep_profile(index)
    assert j.uep_find_index(prof.subchannel_size, prof.protection_level) == \
        t.uep_find_index(prof.subchannel_size, prof.protection_level)
    _assert_msc_schedule_same(dict(start_address=0,
                                   length=prof.subchannel_size, is_uep=True,
                                   uep_table_index=index))


@pytest.mark.parametrize("eep_type,level,length", [
    ("A", 0, 12), ("A", 1, 16), ("A", 2, 48), ("A", 3, 864), ("A", 2, 144),
    ("B", 0, 27), ("B", 1, 42), ("B", 2, 36), ("B", 3, 45),
])
def test_eep_schedules_match(eep_type, level, length):
    j, t = both("params.protection")
    assert_same(j.get_eep_profile(eep_type, level, length),
                t.get_eep_profile(eep_type, level, length), "profile")
    assert j.eep_bitrate_kbps(eep_type, level, length) == \
        t.eep_bitrate_kbps(eep_type, level, length)
    _assert_msc_schedule_same(dict(start_address=3, length=length,
                                   is_uep=False, eep_type=eep_type,
                                   eep_prot_level=level))


def test_label_tables_match():
    j, t = both("params.tables")
    for code in range(0, 64):
        assert j.programme_type_label(code) == t.programme_type_label(code)
        assert j.programme_type_label(code, 2) == t.programme_type_label(code, 2)
    for code in range(0, 256):
        assert j.language_label(code) == t.language_label(code)
    for ecc in (0xE0, 0xE1, 0xE2, 0xE3, 0xE4, 0xA0, 0xF0, 0x00):
        for cid in range(16):
            assert j.country_label(ecc, cid) == t.country_label(ecc, cid)


# --------------------------------------------------------------------- ops

def test_crc_matches():
    j, t = both("ops.crc")
    rng = np.random.default_rng(0)
    bufs = [rng.integers(0, 256, n).astype(np.uint8).tobytes()
            for n in (1, 2, 30, 32, 255, 4096)]
    for buf in bufs:
        assert j.crc16(buf) == t.crc16(buf)
        assert j.crc16(buf, init=0, final_xor=0) == t.crc16(buf, init=0,
                                                            final_xor=0)
        assert j.firecode_crc16(buf) == t.firecode_crc16(buf)
        c = t.crc16(buf)
        good = buf + bytes([c >> 8, c & 0xFF])
        assert j.crc16_check(good) and t.crc16_check(good)
        assert j.crc16_check(buf + b"\0\0") == t.crc16_check(buf + b"\0\0")
    # the port's in-place blocks against the JAX package's ragged CRC
    bounds = np.cumsum([0] + [len(b) for b in bufs])
    assert_same(j.crc16_ragged(bufs), t.crc16_bounds(
        np.frombuffer(b"".join(bufs), np.uint8), bounds), "ragged")
    block = rng.integers(0, 256, (7, 32)).astype(np.uint8)
    assert_same(j.crc16_batch(block), t.crc16_batch(block), "batch")
    assert_same(j.crc16_check_batch(block), t.crc16_check_batch(block), "check")


def test_scrambler_matches():
    j, t = both("ops.scrambler")
    for n in (1, 30, 768, 5184):
        assert_same(j.prbs_bytes(n), t.prbs_bytes(n), f"prbs {n}")
    assert_same(j.prbs_bits(1000), t.prbs_bits(1000), "bits")
    data = np.random.default_rng(1).integers(0, 256, 300).astype(np.uint8)
    assert_same(j.descramble(data), t.descramble(data), "descramble")


@pytest.mark.parametrize("which,nroots,pad,nb_errors", [
    ("dab_plus_rs", 10, 135, 5), ("dab_plus_rs", 10, 135, 7),
    ("packet_rs", 16, 51, 8), ("packet_rs", 16, 51, 0),
])
def test_reed_solomon_matches(which, nroots, pad, nb_errors):
    j, t = both("ops.rs")
    rng = np.random.default_rng(nb_errors)
    k = 255 - pad - nroots
    msg = rng.integers(0, 256, (9, k)).astype(np.uint8)
    cw = j.rs_encode(msg, nroots, pad)
    assert_same(cw, t.rs_encode(msg, nroots, pad), "encode")
    bad = cw.copy()
    for row in bad[:-1]:                       # the last row stays clean
        pos = rng.choice(bad.shape[1], nb_errors, replace=False)
        row[pos] ^= rng.integers(1, 256, nb_errors).astype(np.uint8)
    assert_same(getattr(j, which)().decode(bad),
                getattr(t, which)().decode(bad), "decode")
    assert_same(j.rs_syndromes_numpy(bad, nroots, pad),
                t.rs_syndromes_numpy(bad, nroots, pad), "syndromes")
    if nb_errors <= nroots // 2:
        np.testing.assert_array_equal(
            np.asarray(getattr(t, which)().decode(bad)[0]), cw)


def test_syndrome_bit_matrix_matches():
    j, t = both("ops.rs")
    assert_same(j.syndrome_bit_matrix(10, 135), t.syndrome_bit_matrix(10, 135),
                "matrix")


def test_qmf_banks_match():
    j, t = both("ops.qmf")
    x = np.random.default_rng(2).standard_normal(32 * 40)
    aj, at = j.AnalysisQMF(), t.AnalysisQMF()
    sj, st = j.SynthesisQMF(), t.SynthesisQMF()
    for i in range(0, 40, 8):                  # streaming, state carried
        Wj, Wt = (a.process(x[32 * i:32 * (i + 8)]) for a in (aj, at))
        assert_same(Wj, Wt, "analysis")
        X = np.zeros((Wj.shape[0], 64), complex)
        X[:, :32] = Wj
        assert_same(sj.process(X), st.process(X), "synthesis")


# ------------------------------------------------ dab: bits, labels, FIG

def test_bit_io_and_huffman_match():
    j, t = both("dab.bits")
    jt, tt = both("dab.aac_tables")
    rng = np.random.default_rng(3)
    fields = [(int(rng.integers(0, 1 << n)), int(n))
              for n in rng.integers(1, 25, 200)]
    out = []
    for m in (j, t):
        bw = m.BitWriter()
        for v, n in fields:
            bw.write(v, n)
        bw.align(1)
        other = m.BitWriter()
        other.write(0x2B, 7)
        bw.extend(other)
        out.append(bw.tobytes())
        br = m.BitReader(out[-1])
        assert [br.read(n) for _, n in fields] == [v for v, _ in fields]
        br.align()
        assert br.read(7) == 0x2B
    assert out[0] == out[1]
    idx = rng.integers(0, 60, 300)
    coded = []
    for m, tab in ((j, jt), (t, tt)):
        huff, bw = tab.scalefactor_huffman(), m.BitWriter()
        for i in idx:
            huff.encode(bw, int(i))
        coded.append(bw.tobytes())
        br = m.BitReader(coded[-1])
        assert [huff.decode(br) for _ in idx] == list(idx)
    assert coded[0] == coded[1]


def test_charsets_match():
    j, t = both("dab.charsets")
    rng = np.random.default_rng(4)
    for _ in range(50):
        buf = rng.integers(0, 256, 16).astype(np.uint8).tobytes()
        for cs in (0, 6, 15, 4):
            assert j.decode_label(buf, cs) == t.decode_label(buf, cs)
        flag = int(rng.integers(0, 1 << 16))
        assert j.abbreviated_label(buf, flag) == t.abbreviated_label(buf, flag)


def _ensemble(tone=True):
    """The port's transmitter with a DAB+ HE-AAC v2, a DAB+ LC, an MP2 and a
    packet-mode service; with tone audio where the codec shim allows."""
    from dab_radio_tpu_torch.dab.aac import SuperFrameHeader
    from dab_radio_tpu_torch.models.transmitter import (EnsembleTransmitter,
                                                        ServiceSpec)
    from dab_radio_tpu_torch.params import SubchannelConfig
    eep = dict(is_uep=False, eep_type="A", eep_prot_level=2)
    services = [
        ServiceSpec(0xF201, 1, "HE v2", SubchannelConfig(0, 48, **eep),
                    superframe_header=SuperFrameHeader(48000, True, True,
                                                       True, 0)),
        ServiceSpec(0xF202, 2, "LC mono", SubchannelConfig(48, 48, **eep),
                    superframe_header=SuperFrameHeader(48000, False, False,
                                                       False, 0)),
        ServiceSpec(0xF203, 3, "Classic", SubchannelConfig(
            96, 84, True, uep_table_index=35), kind="dab"),
        ServiceSpec(0xF204, 4, "Data", SubchannelConfig(180, 12, **eep),
                    kind="packet", scid=5, packet_address=42),
    ]
    tx = EnsembleTransmitter(1, services=services, device="cpu")
    if tone:
        tx.enable_tone_audio()
    return tx


@pytest.fixture(scope="module")
def fibs():
    tx = _ensemble(tone=False)
    out = []
    for _ in range(12):
        for p in tx._fib_payloads():
            fib = p + b"\xff" * (30 - len(p))
            out.append(fib)
    # a FIB with a date and time, country and a second label charset
    from dab_radio_tpu_torch.models import transmitter as T
    extra = (T.fig0_9_country(lto=2, ecc=0xE2) +
             T.fig0(10, bytes([0x80 | 0x3A, 0x5B, 0xC0 | 0x0A, 0x2D])) +
             T.fig1_label(1, (0xF201).to_bytes(2, "big"), "Caf\xe9 radio", 0))
    out.append(extra + b"\xff" * (30 - len(extra)))
    return out


@pytest.mark.parametrize("parser", ["numpy", "native"])
def test_fig_parse_into_database_matches(fibs, parser):
    jf, tf = both("dab.fig")
    jn, tn = both("dab.fig_native")
    jd, td = both("dab.database")
    if parser == "numpy":
        pj, pt = jf.FIGParser(), tf.FIGParser()
    else:
        pj, pt = jn.NativeFIGParser(), tn.NativeFIGParser()
        assert pj.is_native == pt.is_native
    uj, ut = jd.DatabaseUpdater(), td.DatabaseUpdater()
    nb_events = 0
    for fib in fibs:
        ej, et = pj.parse_fib(fib), pt.parse_fib(fib)
        assert_same(ej, et, "events")
        nb_events += len(et)
        for e in ej:
            uj.apply(e)
        for e in et:
            ut.apply(e)
    assert nb_events > 50
    for field in ("ensemble", "services", "service_components", "subchannels",
                  "link_services", "other_ensembles", "fm_services",
                  "drm_services", "amss_services"):
        assert_same(getattr(uj.db, field), getattr(ut.db, field), field)
    assert_same(uj.misc, ut.misc, "misc")
    assert (uj.conflicts, uj.updates) == (ut.conflicts, ut.updates)
    assert_same(uj.stats(), ut.stats(), "stats")
    assert ut.db.ensemble.id == 0xC0FE and len(ut.db.services) == 4
    assert ut.db.component_by_subchannel(3).service_id == 0xF203


# --------------------------------------------- dab: audio and data protocols

@pytest.mark.parametrize("header_fields", [
    (48000, True, True, False, 0), (32000, False, False, False, 0),
    (48000, True, True, True, 0),
])
def test_superframe_encode_decode_matches(header_fields):
    j, t = both("dab.aac")
    rng = np.random.default_rng(5)
    frames_j = frames_t = None
    procs = (j.SuperframeProcessor(), t.SuperframeProcessor())
    hj, ht = j.SuperFrameHeader(*header_fields), t.SuperFrameHeader(*header_fields)
    assert (hj.num_aus, hj.core_sample_rate) == (ht.num_aus, ht.core_sample_rate)
    assert j.mpeg4_audio_specific_config(hj) == t.mpeg4_audio_specific_config(ht)
    assert j.adts_header(hj, 211) == t.adts_header(ht, 211)
    ej, et = j.SuperframeEncoder(360, hj), t.SuperframeEncoder(360, ht)
    assert ej.au_capacity() == et.au_capacity()
    for sf in range(3):
        cap, n = et.au_capacity(), ht.num_aus
        sizes = [cap // n] * (n - 1) + [cap - cap // n * (n - 1)]
        aus = [rng.integers(0, 256, s).astype(np.uint8).tobytes() for s in sizes]
        frames_j, frames_t = ej.encode(aus), et.encode(aus)
        assert frames_j == frames_t
        if sf == 1:                            # RS-correctable damage
            blob = bytearray(b"".join(frames_t))
            for pos in rng.choice(len(blob) - 400, 4, replace=False):
                blob[400 + int(pos)] ^= 0x5A
            frames_t = [bytes(blob[i * 360:(i + 1) * 360]) for i in range(5)]
        res = None
        for f in frames_t:
            rj, rt = (p.process_frame(f) for p in procs)
            assert_same(rj, rt, "superframe result")
            res = rt or res
        assert res is not None and res[1] == aus
    assert_same(procs[0].stats, procs[1].stats, "stats")
    assert procs[1].stats["superframes"] == 3


def test_aac_tables_match():
    j, t = both("dab.aac_tables")
    for sri in range(13):
        for n in (960, 1024):
            try:
                ref = j.swb_offsets(sri, n)
            except KeyError:
                with pytest.raises(KeyError):
                    t.swb_offsets(sri, n)
                continue
            assert_same(ref, t.swb_offsets(sri, n), "swb")
            assert j.num_swb(sri, n) == t.num_swb(sri, n)
    for cb in j.SPECTRAL_CB:
        assert_same(j.spectral_huffman(cb), t.spectral_huffman(cb), f"cb {cb}")
    assert_same(j.scalefactor_huffman(), t.scalefactor_huffman(), "sf huffman")
    assert_same(j.sbr_qmf_window(), t.sbr_qmf_window(), "window")
    assert_same(j.sbr_qmf_window(True), t.sbr_qmf_window(True), "window ds")
    for fn in ("sbr_noise_table", "sbr_limiter_gains", "sbr_bw_table"):
        assert_same(getattr(j, fn)(), getattr(t, fn)(), fn)
    for rate in (32000, 48000, 24000, 16000):
        assert_same(j.sbr_k0_offset(rate), t.sbr_k0_offset(rate), "k0")
    # the two .npz files hold the same keys and arrays
    with np.load(j._NPZ) as zj, np.load(t._NPZ) as zt:
        assert sorted(zj.files) == sorted(zt.files) and len(zj.files) > 20
        for k in zj.files:
            assert_same(zj[k], zt[k], k)
    assert j._NPZ != t._NPZ


def _tone_au(ps: bool, stereo: bool, sbr: bool = True):
    """One tone access unit from each package's encoder chain."""
    out = []
    for pkg in ("dab_radio_tpu", "dab_radio_tpu_torch"):
        aac = importlib.import_module(f"{pkg}.dab.aac")
        tr = importlib.import_module(f"{pkg}.models.transmitter")
        hdr = aac.SuperFrameHeader(48000, stereo, sbr, ps, 0)
        src = tr.ToneAudioSource(hdr, freq=880.0, xpad=b"\x01\x02\x03")
        out.append((hdr, src(600, 3)))
    (hj, aj), (ht, at) = out
    assert aj == at
    return hj, ht, at


@pytest.mark.parametrize("ps,stereo,sbr", [(True, True, True),
                                           (False, True, True),
                                           (False, False, False)])
def test_aac_encoder_walker_and_sbr_parse_match(ps, stereo, sbr):
    jw, tw = both("dab.aac_bits")
    js, ts = both("dab.sbr")
    hj, ht, aus = _tone_au(ps, stereo, sbr)
    au = aus[0]
    wj, wt = jw.RawDataBlockWalker(6 if sbr else 3), \
        tw.RawDataBlockWalker(6 if sbr else 3)
    rj, rt = wj.walk(au), wt.walk(au)
    assert_same(rj, rt, "walk")
    assert rt.has_sbr == sbr
    assert wj.strip_sbr(au, rj) == wt.strip_sbr(au, rt)
    if not sbr:
        return
    pj, pt = rj.sbr[0], rt.sbr[0]
    is_cpe = stereo and not ps
    fj = js.SBRBitstream(48000, 15, is_cpe=is_cpe).parse(pj.data, pj.nbits,
                                                         pj.has_crc)
    ft = ts.SBRBitstream(48000, 15, is_cpe=is_cpe).parse(pt.data, pt.nbits,
                                                         pt.has_crc)
    assert_same(fj, ft, "sbr frame")
    assert (ft.ps is not None) == ps


@pytest.mark.parametrize("ps,stereo", [(True, True), (False, True),
                                       (False, False)])
def test_sbr_and_ps_synthesis_match(ps, stereo):
    """SBRDecoder.decode_frame (QMF analysis, HF generation, envelope
    adjustment, PS synthesis, QMF synthesis) on the same core PCM and the
    same payload: the float output is identical."""
    jw, tw = both("dab.aac_bits")
    js, ts = both("dab.sbr")
    _, _, aus = _tone_au(ps, stereo)
    p = tw.RawDataBlockWalker(6).walk(aus[0]).sbr[0]
    ch = 2 if (stereo and not ps) else 1
    dj = js.SBRDecoder(48000, num_time_slots=15, is_cpe=ch == 2)
    dt = ts.SBRDecoder(48000, num_time_slots=15, is_cpe=ch == 2)
    rng = np.random.default_rng(6)
    n = np.arange(960 * 6) / 24000
    core = (6000 * np.sin(2 * np.pi * 880 * n)[:, None]
            + 200 * rng.standard_normal((n.shape[0], ch)))
    for i in range(6):
        blk = core[960 * i:960 * (i + 1)]
        oj = dj.decode_frame(blk, p.data, p.nbits, p.has_crc)
        ot = dt.decode_frame(blk, p.data, p.nbits, p.has_crc)
        assert_same(oj, ot, f"frame {i}")
    assert ot.shape == (1920, 2 if (ps or ch == 2) else 1)
    assert np.abs(ot).max() > 1000


def test_ps_bitstream_and_synthesis_match():
    jb, tb = both("dab.bits")
    jp, tp = both("dab.ps")
    js, ts = both("dab.ps_synth")
    rng = np.random.default_rng(7)
    iid = np.cumsum(rng.integers(-2, 3, (2, jp.nr_par(1))), axis=1)
    icc = np.clip(np.cumsum(rng.integers(-1, 2, (2, jp.nr_par(1))), axis=1),
                  0, 7)
    parsed, blobs = [], []
    for bits, ps in ((jb, jp), (tb, tp)):
        d = ps.PSData(enable_iid=True, iid_mode=1, enable_icc=True, icc_mode=1,
                      num_env=2)
        d.iid_par, d.icc_par = iid.copy(), icc.copy()
        bw = bits.BitWriter()
        ps.write_ps_data(bw, d, nts=32)
        blobs.append(bw.tobytes())
        parsed.append(ps.PSBitstream(32).parse(bits.BitReader(blobs[-1])))
    assert blobs[0] == blobs[1]
    assert_same(parsed[0], parsed[1], "ps data")
    X = rng.standard_normal((32, 64)) + 1j * rng.standard_normal((32, 64))
    sj, st = js.PSSynthesis(n_slots=32), ts.PSSynthesis(n_slots=32)
    for _ in range(3):
        assert_same(sj.process(X, parsed[0]), st.process(X, parsed[1]), "L/R")


def test_mp2_helpers_match():
    j, t = both("dab.mp2")
    rng = np.random.default_rng(8)
    for kbps_index in (4, 8, 12):
        hdr = bytes([0xFF, 0xFC, (kbps_index << 4) | (1 << 2), 0x00])
        frame = hdr + rng.integers(0, 256, 700).astype(np.uint8).tobytes()
        hj, ht = j.parse_mp2_header(frame), t.parse_mp2_header(frame)
        assert_same(hj, ht, "header")
        assert j.locate_pad(frame, hj) == t.locate_pad(frame, ht)
        ej, et = j.MP2PadExtractor(), t.MP2PadExtractor()
        assert_same(ej.process_frame(frame), et.process_frame(frame), "pad")
    assert j.parse_mp2_header(b"\x00" * 8) is None
    assert t.parse_mp2_header(b"\x00" * 8) is None


def _mot_groups(body, tid=77):
    jm, _ = both("dab.mot")
    hdr = bytearray(pad_writer.build_mot_header(body, content_name="slide.png"))
    hdr[5] = (hdr[5] & 0x81) | (2 << 1)          # content type: image
    hdr[6] = 3                                   # subtype: png
    groups = [pad_writer.build_mot_segment(jm.HEADER, 0, True, tid, bytes(hdr))]
    segs = [body[i:i + 128] for i in range(0, len(body), 128)]
    for i, s in enumerate(segs):
        groups.append(pad_writer.build_mot_segment(
            jm.UNSCRAMBLED_BODY, i, i == len(segs) - 1, tid, s))
    return groups


@pytest.mark.parametrize("what", ["label", "slideshow", "dse"])
def test_pad_mot_slideshow_match(what):
    jp, tp = both("dab.pad")
    js, ts = both("dab.slideshow")
    jd, td = both("dab.aac_data")
    body = np.random.default_rng(9).integers(0, 256, 500).astype(
        np.uint8).tobytes()
    got = []
    for pad, slideshow, data in ((jp, js, jd), (tp, ts, td)):
        labels, slides, entities = [], [], []
        if what == "dse":
            dec = data.AACDataDecoder()
            proc = dec.pad
        else:
            proc = pad.PADProcessor()
        proc.on_label.append(labels.append)
        mgr = slideshow.SlideshowManager()
        mgr.on_slideshow.append(slides.append)
        proc.on_mot_entity.append(entities.append)
        proc.on_mot_entity.append(mgr.process_mot_entity)
        if what == "slideshow":
            for g in _mot_groups(body):
                for fpad, xpad in pad_writer.chunk_xpad_fields(
                        g, 12, 13, length_prefix=pad_writer.dli_prefix(len(g))):
                    proc.process(fpad, xpad)
        else:
            for g in pad_writer.label_data_groups("Now playing: parity"):
                for fpad, xpad in pad_writer.chunk_xpad_fields(g, 2, 3):
                    if what == "dse":
                        au = data.build_data_stream_element(fpad, xpad) \
                            + b"\xAA" * 10
                        assert dec.process_access_unit(au)
                    else:
                        proc.process(fpad, xpad)
        got.append((labels, slides, entities))
    assert_same(got[0], got[1], what)
    labels, slides, _ = got[1]
    if what == "slideshow":
        assert len(slides) == 1 and slides[0].data == body
        assert slides[0].image_type == "png" and slides[0].name == "slide.png"
    else:
        assert labels[-1] == "Now playing: parity"


@pytest.mark.parametrize("fec", [False, True])
def test_packet_mode_matches(fec):
    jp, tp = both("dab.packets")
    body = np.random.default_rng(10).integers(0, 256, 700).astype(
        np.uint8).tobytes()
    groups = _mot_groups(body, tid=0x1234)
    streams, got = [], []
    for m in (jp, tp):
        enc = m.PacketStreamEncoder(42)
        for g in groups:
            enc.push_data_group(g)
        streams.append(b"".join(enc.emit(288) for _ in range(12)))
        assert m.idle_packet() == jp.idle_packet()
        assert_same(m.packetize_data_group(groups[1], 42, 1),
                    jp.packetize_data_group(groups[1], 42, 1), "packetize")
        assert_same(m.parse_data_group(groups[0]), jp.parse_data_group(groups[0]),
                    "data group")
    assert streams[0] == streams[1]
    for m in (jp, tp):
        proc = m.PacketProcessor(packet_address=42, use_fec=fec)
        entities = []
        proc.mot.on_entity.append(entities.append)
        proc.process(streams[0])
        got.append((entities, dict(proc.stats)))
    assert_same(got[0], got[1], "packet results")
    if not fec:
        assert len(got[1][0]) == 1 and got[1][0][0].body == body


# -------------------------------------------------------------------- host

def test_native_status_reports_every_library():
    from dab_radio_tpu_torch.host import native as tn
    from dab_radio_tpu.host import native as jn
    status = tn.native_status()
    assert sorted(status) == ["dabcodecs", "dabfig", "dabio"]
    assert status["dabio"] == ("shared library" if jn.io_lib() is not None
                               else "numpy")
    assert status["dabfig"] == ("shared library" if jn.fig_lib() is not None
                                else "numpy")
    assert status["dabcodecs"] == ("shared library"
                                   if jn.codecs_lib() is not None
                                   else "unavailable")
    # both packages load the same native/ directory at the root
    assert tn._NATIVE_DIR == jn._NATIVE_DIR and tn._BUILD_DIR == jn._BUILD_DIR


@pytest.mark.parametrize("fmt", [
    "u8", "s8", "u16le", "s16le", "u16be", "s16be", "u32le", "s32le", "u32be",
    "s32be", "f32le", "f32be", "f64le", "f64be"])
def test_iq_reader_matches(fmt):
    jn, tn = both("host.native")
    jio, tio = both("host.io")
    assert jn.IQ_FORMATS == tn.IQ_FORMATS and fmt in tn.IQ_FORMATS
    rng = np.random.default_rng(11)
    if fmt[0] == "f":
        dtype = "<>"[fmt.endswith("be")] + "f" + str(int(fmt[1:3]) // 8)
        raw = rng.uniform(-1, 1, 4000).astype(dtype).tobytes()
    else:
        raw = rng.integers(0, 256, 4000 * int(fmt[1:3].rstrip("lb") or 8) // 8
                           ).astype(np.uint8).tobytes()
    assert_same(jn.iq_convert(raw, fmt), tn.iq_convert(raw, fmt), "convert")
    rj, rt = jio.IQReader(io.BytesIO(raw), fmt), tio.IQReader(io.BytesIO(raw), fmt)
    while True:
        bj, bt = rj.read_block(1000), rt.read_block(1000)
        assert_same(bj, bt, "block")
        if bt is None:
            break
    assert rj.saturation == rt.saturation
    assert rj.clipping_warning() == rt.clipping_warning()


def test_native_converters_and_wav_header_match():
    jn, tn = both("host.native")
    jio, tio = both("host.io")
    rng = np.random.default_rng(12)
    iq = (rng.normal(size=3000) + 1j * rng.normal(size=3000)).astype(
        np.complex64) * 0.4
    assert jn.iq_quantize_u8(iq) == tn.iq_quantize_u8(iq)
    soft = rng.integers(-127, 128, 4096).astype(np.int8)
    hard = tn.soft_to_hard(soft)
    assert jn.soft_to_hard(soft) == hard
    assert_same(jn.hard_to_soft(hard, 4096), tn.hard_to_soft(hard, 4096), "soft")
    u8 = rng.integers(0, 256, 5000).astype(np.uint8)
    assert jio.u8_saturation(u8) == tio.u8_saturation(u8)
    import struct
    wav = (b"RIFF" + struct.pack("<I", 36 + 64) + b"WAVEfmt "
           + struct.pack("<IHHIIHH", 16, 1, 2, 2048000, 4096000, 2, 8)
           + b"data" + struct.pack("<I", 64) + bytes(64))
    assert_same(jio.parse_wav_header(io.BytesIO(wav)),
                tio.parse_wav_header(io.BytesIO(wav)), "wav header")
    if tn.io_lib() is not None:
        for m in (jn, tn):
            ring = m.NativeRingBuffer(64)
            assert ring.write(b"abcdefgh") == 8 and len(ring) == 8
            assert ring.read(5) == b"abcde"
            ring.close()


def test_codecs_decode_tone_audio_match():
    """AAC (LC core through libavcodec, then the numpy SBR and PS stages)
    and MP2 decode of the transmitter's tone audio: identical PCM."""
    jc, tc = both("host.codecs")
    jn, _ = both("host.native")
    if jn.codecs_lib() is None:
        assert not tc.MP2Decoder().is_available
        pytest.skip("libavcodec shim unavailable")
    hj, ht, aus = _tone_au(True, True)
    dj, dt = jc.AACDecoder(hj), tc.AACDecoder(ht)
    assert dj.is_available == dt.is_available
    assert dj.adts_frame(aus[0]) == dt.adts_frame(aus[0])
    nb = 0
    for au in aus * 3:
        oj, ot = dj.decode_au(au), dt.decode_au(au)
        assert_same(oj, ot, "aac pcm")
        nb += ot is not None
    assert nb >= 6
    dj.close()
    dt.close()
    from dab_radio_tpu_torch.models.transmitter import MP2ToneSource
    src = MP2ToneSource(384 * 24 // 8 * 8 // 8)
    if src.is_available:
        mj, mt = jc.MP2Decoder(), tc.MP2Decoder()
        for _ in range(4):
            f = src()
            assert_same(mj.decode(f), mt.decode(f), "mp2 pcm")
        mj.close()
        mt.close()


def test_audio_pipeline_and_wav_sink_match(tmp_path):
    ja, ta = both("host.audio")
    rng = np.random.default_rng(13)
    pcm = (rng.standard_normal((4800, 2)) * 3000).astype(np.int16)
    mono = (rng.standard_normal((2400, 1)) * 3000).astype(np.int16)
    blobs = []
    for name, m in (("j.wav", ja), ("t.wav", ta)):
        pipe = m.AudioPipeline()
        a, b = pipe.create_source(), pipe.create_source()
        a.write(pcm, 48000, 2)
        b.write(mono, 24000, 1)
        mixed = pipe.mix_block(4800)
        sink = m.WavFileSink(str(tmp_path / name), 48000, 2)
        sink.write_frames(mixed)
        sink.write_pcm16(pcm)
        sink.close()
        blobs.append(((tmp_path / name).read_bytes(), mixed))
    assert blobs[0][0] == blobs[1][0] and len(blobs[1][0]) > 19000
    assert_same(blobs[0][1], blobs[1][1], "mixed")


def test_scraper_writes_the_same_files(tmp_path):
    js, ts = both("host.scraper")
    jaac, taac = both("dab.aac")
    jm, tm = both("dab.mot")
    rng = np.random.default_rng(14)
    au = rng.integers(0, 256, 200).astype(np.uint8).tobytes()
    trees = []
    for name, scraper, aac, mot in (("j", js, jaac, jm), ("t", ts, taac, tm)):
        root = tmp_path / name
        ch = scraper.ChannelScraper(str(root), 7, "dab+")
        hdr = aac.SuperFrameHeader(48000, True, True, False, 0)
        for i in range(3):
            ch.on_access_unit(i, 3, au, hdr)
        ch.on_mp2_frame(au)
        ch.on_dynamic_label("a label")
        ch.on_pcm((rng.standard_normal((960, 2)) * 0).astype(np.int16),
                  48000, 2)
        ch.close()
        trees.append({str(p.relative_to(root)): p.read_bytes()
                      for p in sorted(root.rglob("*")) if p.is_file()})
    assert list(trees[0]) == list(trees[1]) and len(trees[1]) >= 3
    for k in trees[0]:
        if not k.endswith(".txt"):             # the label log carries a time
            assert trees[0][k] == trees[1][k], k
