"""UEP/EEP subchannel protection profiles.

ETSI EN 300 401 clauses 6.2.1 and 11.3: UEP table (tables 8+15, 64 rows) and
EEP type A/B profiles (tables 9/10 + 18/20) with the 2-A short-form special
case. Parity surface: reference
src/dab/constants/subchannel_protection_tables.h:21-170.
"""

from dataclasses import dataclass

from .puncture import get_puncture_vector, PI_X_VECTOR


@dataclass(frozen=True)
class UEPProfile:
    subchannel_size: int          # capacity units
    bitrate_kbps: int
    protection_level: int
    Lx: tuple                     # number of 128-symbol blocks per puncture code
    PIx: tuple                    # puncture code ids
    padding_bits: int


# (size CU, bitrate kbps, level, L1..L4, PI1..PI4, padding)
_UEP_ROWS = [
    (16, 32, 5, (3, 4, 17, 0), (5, 3, 2, 0), 0),
    (21, 32, 4, (3, 3, 18, 0), (11, 6, 5, 0), 0),
    (24, 32, 3, (3, 4, 14, 3), (15, 9, 6, 8), 0),
    (29, 32, 2, (3, 4, 14, 3), (22, 13, 8, 13), 0),
    (35, 32, 1, (3, 5, 13, 3), (24, 17, 12, 17), 4),
    (24, 48, 5, (4, 3, 26, 3), (5, 4, 2, 3), 0),
    (29, 48, 4, (3, 4, 26, 3), (9, 6, 4, 6), 0),
    (35, 48, 3, (3, 4, 26, 3), (15, 10, 6, 9), 4),
    (42, 48, 2, (3, 4, 26, 3), (24, 14, 8, 15), 0),
    (52, 48, 1, (3, 5, 25, 3), (24, 18, 13, 18), 0),
    (29, 56, 5, (6, 10, 23, 3), (5, 4, 2, 3), 0),
    (35, 56, 4, (6, 10, 23, 3), (9, 6, 4, 5), 0),
    (42, 56, 3, (6, 12, 21, 3), (16, 7, 6, 9), 0),
    (52, 56, 2, (6, 10, 23, 3), (23, 13, 8, 13), 8),
    (32, 64, 5, (6, 9, 31, 2), (5, 3, 2, 3), 0),
    (42, 64, 4, (6, 9, 33, 0), (11, 6, 5, 0), 0),
    (48, 64, 3, (6, 12, 27, 3), (16, 8, 6, 9), 0),
    (58, 64, 2, (6, 10, 29, 3), (23, 13, 8, 13), 8),
    (70, 64, 1, (6, 11, 28, 3), (24, 18, 12, 18), 4),
    (40, 80, 5, (6, 10, 41, 3), (6, 3, 2, 3), 0),
    (52, 80, 4, (6, 10, 41, 3), (11, 6, 5, 6), 0),
    (58, 80, 3, (6, 11, 40, 3), (16, 8, 6, 7), 0),
    (70, 80, 2, (6, 10, 41, 3), (23, 13, 8, 13), 8),
    (84, 80, 1, (6, 10, 41, 3), (24, 17, 12, 18), 4),
    (48, 96, 5, (7, 9, 53, 3), (5, 4, 2, 4), 0),
    (58, 96, 4, (7, 10, 52, 3), (9, 6, 4, 6), 0),
    (70, 96, 3, (6, 12, 51, 3), (16, 9, 6, 10), 4),
    (84, 96, 2, (6, 10, 53, 3), (22, 12, 9, 12), 0),
    (104, 96, 1, (6, 13, 50, 3), (24, 18, 13, 19), 0),
    (58, 112, 5, (14, 17, 50, 3), (5, 4, 2, 5), 0),
    (70, 112, 4, (11, 21, 49, 3), (9, 6, 4, 8), 0),
    (84, 112, 3, (11, 23, 47, 3), (16, 8, 6, 9), 0),
    (104, 112, 2, (11, 21, 49, 3), (23, 12, 9, 14), 4),
    # NOTE: the reference (subchannel_protection_tables.h rows for 128 kbps
    # levels 5/4) swaps these two subchannel sizes; the coded-bit budget only
    # balances as 64 CU <-> level 5 and 84 CU <-> level 4, matching ETSI
    # table 8 (punctured symbols + padding == 64*CU, verified in tests).
    (64, 128, 5, (12, 19, 62, 3), (5, 3, 2, 4), 0),
    (84, 128, 4, (11, 21, 61, 3), (11, 6, 5, 7), 0),
    (96, 128, 3, (11, 22, 60, 3), (16, 9, 6, 10), 4),
    (116, 128, 2, (11, 21, 61, 3), (22, 12, 9, 14), 0),
    (140, 128, 1, (11, 20, 62, 3), (24, 17, 13, 19), 8),
    (80, 160, 5, (11, 19, 87, 3), (5, 4, 2, 4), 0),
    (104, 160, 4, (11, 23, 83, 3), (11, 6, 5, 9), 0),
    (116, 160, 3, (11, 24, 82, 3), (16, 8, 6, 11), 0),
    (140, 160, 2, (11, 21, 85, 3), (22, 11, 9, 13), 0),
    (168, 160, 1, (11, 22, 84, 3), (24, 18, 12, 19), 0),
    (96, 192, 5, (11, 20, 110, 3), (6, 4, 2, 5), 0),
    (116, 192, 4, (11, 22, 108, 3), (10, 6, 4, 9), 0),
    (140, 192, 3, (11, 24, 106, 3), (16, 10, 6, 11), 0),
    (168, 192, 2, (11, 20, 110, 3), (22, 13, 9, 13), 8),
    (208, 192, 1, (11, 21, 109, 3), (24, 20, 13, 24), 0),
    (116, 224, 5, (12, 22, 131, 3), (8, 6, 2, 6), 4),
    (140, 224, 4, (12, 26, 127, 3), (12, 8, 4, 11), 0),
    (168, 224, 3, (11, 20, 134, 3), (16, 10, 7, 9), 0),
    (208, 224, 2, (11, 22, 132, 3), (24, 16, 10, 15), 0),
    (232, 224, 1, (11, 24, 130, 3), (24, 20, 12, 20), 4),
    (128, 256, 5, (11, 24, 154, 3), (6, 5, 2, 5), 0),
    (168, 256, 4, (11, 24, 154, 3), (12, 9, 5, 10), 4),
    (192, 256, 3, (11, 27, 151, 3), (16, 10, 7, 10), 0),
    (232, 256, 2, (11, 22, 156, 3), (24, 14, 10, 13), 8),
    (280, 256, 1, (11, 26, 152, 3), (24, 19, 14, 18), 4),
    (160, 320, 5, (11, 26, 200, 3), (8, 5, 2, 6), 4),
    (208, 320, 4, (11, 25, 201, 3), (13, 9, 5, 10), 8),
    (280, 320, 2, (11, 26, 200, 3), (24, 17, 9, 17), 0),
    (192, 384, 5, (11, 27, 247, 3), (8, 6, 2, 7), 0),
    (280, 384, 3, (11, 24, 250, 3), (16, 9, 7, 10), 4),
    (416, 384, 1, (12, 28, 245, 3), (24, 20, 14, 23), 8),
]

UEP_TABLE = [UEPProfile(*row) for row in _UEP_ROWS]


def get_uep_profile(table_index: int) -> UEPProfile:
    return UEP_TABLE[table_index]


def uep_find_index(subchannel_size: int,
                   protection_level: int | None = None) -> int:
    """Find the UEP table row for a subchannel size (optionally also matching
    the protection level). FIG 0/1 short form carries the table index
    directly; this helper resolves the row when only size (+level) is known,
    e.g. when cross-checking FIG 0/1 against an externally-configured mux.
    Raises ValueError when no row matches (sizes/levels are unique per row in
    ETSI EN 300 401 table 8)."""
    for idx, row in enumerate(UEP_TABLE):
        if row.subchannel_size != subchannel_size:
            continue
        if protection_level is not None and row.protection_level != protection_level:
            continue
        return idx
    raise ValueError(
        f"no UEP profile with size={subchannel_size} CU"
        + ("" if protection_level is None else f", level={protection_level}"))


@dataclass(frozen=True)
class EEPProfile:
    capacity_unit_multiple: int
    L1_eq: tuple   # (m, b): L1 = m*n + b
    L2_eq: tuple
    PIx: tuple
    bitrate_multiple: int


# EEP type A, protection levels 1-A..4-A (tables 9 + 18)
EEP_TABLE_A = [
    EEPProfile(12, (6, -3), (0, 3), (24, 23), 8),
    EEPProfile(8, (2, -3), (4, 3), (14, 13), 8),
    EEPProfile(6, (6, -3), (0, 3), (8, 7), 8),
    EEPProfile(4, (4, -3), (2, 3), (3, 2), 8),
]
# special case 2-A with n=1 (subchannel of 8 CU)
EEP_PROFILE_2A_N1 = EEPProfile(8, (0, 5), (0, 1), (13, 12), 8)

# EEP type B, protection levels 1-B..4-B (tables 10 + 20)
EEP_TABLE_B = [
    EEPProfile(27, (24, -3), (0, 3), (10, 9), 32),
    EEPProfile(21, (24, -3), (0, 3), (6, 5), 32),
    EEPProfile(18, (24, -3), (0, 3), (4, 3), 32),
    EEPProfile(15, (24, -3), (0, 3), (2, 1), 32),
]


def get_eep_profile(eep_type: str, prot_level: int, subchannel_size: int) -> EEPProfile:
    """eep_type 'A'|'B', prot_level 0-based (level 1 => 0)."""
    if eep_type == "A":
        if subchannel_size == 8:
            return EEP_PROFILE_2A_N1
        return EEP_TABLE_A[prot_level]
    return EEP_TABLE_B[prot_level]


def eep_bitrate_kbps(eep_type: str, prot_level: int, subchannel_size: int) -> int:
    p = get_eep_profile(eep_type, prot_level, subchannel_size)
    n = subchannel_size // p.capacity_unit_multiple
    return n * p.bitrate_multiple


@dataclass(frozen=True)
class SubchannelConfig:
    """Static decode configuration for one MSC subchannel."""
    start_address: int       # in capacity units
    length: int              # in capacity units
    is_uep: bool
    uep_table_index: int = 0
    eep_type: str = "A"
    eep_prot_level: int = 0  # 0-based

    @property
    def nb_cif_bits(self) -> int:
        return self.length * 64  # 64 bits per capacity unit (mode I..IV MSC)

    def bitrate_kbps(self) -> int:
        if self.is_uep:
            return UEP_TABLE[self.uep_table_index].bitrate_kbps
        return eep_bitrate_kbps(self.eep_type, self.eep_prot_level, self.length)


def msc_puncture_schedule(cfg: SubchannelConfig):
    """[(keep-vector, nb_mother_symbols)] schedule for one CIF of a subchannel
    (reference src/dab/msc/msc_decoder.cpp:77-154)."""
    sched = []
    if cfg.is_uep:
        prof = UEP_TABLE[cfg.uep_table_index]
        for lx, pix in zip(prof.Lx, prof.PIx):
            if lx == 0:
                continue
            sched.append((get_puncture_vector(pix), 128 * lx))
    else:
        prof = get_eep_profile(cfg.eep_type, cfg.eep_prot_level, cfg.length)
        if cfg.length % prof.capacity_unit_multiple or cfg.length <= 0:
            raise ValueError(
                f"EEP {cfg.eep_prot_level + 1}-{cfg.eep_type} subchannel size "
                f"must be a positive multiple of "
                f"{prof.capacity_unit_multiple} CU, got {cfg.length}")
        n = cfg.length // prof.capacity_unit_multiple
        for (m, b), pix in zip((prof.L1_eq, prof.L2_eq), prof.PIx):
            lx = m * n + b
            if lx == 0:
                continue
            sched.append((get_puncture_vector(pix), 128 * lx))
    sched.append((PI_X_VECTOR, 24))
    return sched
