"""OFDM transmission-mode geometry and DAB logical frame parameters.

ETSI EN 300 401 clause 14 (transmission frame) / the system-parameter table.
Parity surface: reference src/ofdm/dab_ofdm_params_ref.cpp:10-58 and
src/dab/constants/dab_parameters.h:26-90. All values relative to the 2.048 MHz
sampling clock.
"""

from dataclasses import dataclass

SAMPLE_RATE_HZ = 2_048_000


@dataclass(frozen=True)
class OFDMParams:
    mode: int
    nb_frame_symbols: int   # symbols per frame including PRS, excluding NULL
    nb_symbol_period: int   # samples per symbol (fft + cyclic prefix)
    nb_null_period: int     # samples in the NULL symbol
    nb_fft: int             # FFT size
    nb_data_carriers: int   # active subcarriers (excludes DC)

    @property
    def nb_cyclic_prefix(self) -> int:
        return self.nb_symbol_period - self.nb_fft

    @property
    def nb_frame_samples(self) -> int:
        """Samples per whole transmission frame (NULL + all symbols)."""
        return self.nb_null_period + self.nb_frame_symbols * self.nb_symbol_period

    @property
    def nb_data_symbols(self) -> int:
        """Data-bearing symbols (frame symbols minus the PRS)."""
        return self.nb_frame_symbols - 1

    @property
    def nb_frame_bits(self) -> int:
        """Soft bits produced per frame (2 bits per carrier per data symbol)."""
        return self.nb_data_symbols * self.nb_data_carriers * 2


_OFDM_MODES = {
    1: OFDMParams(1, 76, 2552, 2656, 2048, 1536),
    2: OFDMParams(2, 76, 638, 664, 512, 384),
    3: OFDMParams(3, 153, 319, 345, 256, 192),
    4: OFDMParams(4, 76, 1276, 1328, 1024, 768),
}


def get_ofdm_params(transmission_mode: int) -> OFDMParams:
    if transmission_mode not in _OFDM_MODES:
        raise ValueError(f"invalid transmission mode {transmission_mode}")
    return _OFDM_MODES[transmission_mode]


@dataclass(frozen=True)
class DABParams:
    """Logical bit-level frame structure (FIC/MSC split, FIBs, CIFs)."""
    mode: int
    nb_frame_bits: int
    nb_symbols: int
    nb_fic_symbols: int
    nb_msc_symbols: int
    nb_fibs: int
    nb_cifs: int
    nb_fibs_per_cif: int

    @property
    def nb_sym_bits(self) -> int:
        return self.nb_frame_bits // self.nb_symbols

    @property
    def nb_fic_bits(self) -> int:
        return self.nb_sym_bits * self.nb_fic_symbols

    @property
    def nb_msc_bits(self) -> int:
        return self.nb_sym_bits * self.nb_msc_symbols

    @property
    def nb_fib_bits(self) -> int:
        return self.nb_fic_bits // self.nb_fibs

    @property
    def nb_fib_cif_bits(self) -> int:
        """Encoded bits per FIB group (one group is decoded per CIF)."""
        return self.nb_fib_bits * self.nb_fibs_per_cif

    @property
    def nb_cif_bits(self) -> int:
        return self.nb_msc_bits // self.nb_cifs


def get_dab_params(transmission_mode: int) -> DABParams:
    o = get_ofdm_params(transmission_mode)
    ncarrier2 = o.nb_data_carriers * 2
    nsym = o.nb_data_symbols
    table = {
        1: DABParams(1, ncarrier2 * nsym, nsym, 3, 72, 12, 4, 3),
        2: DABParams(2, ncarrier2 * nsym, nsym, 3, 72, 3, 1, 3),
        3: DABParams(3, ncarrier2 * nsym, nsym, 8, 144, 4, 1, 4),
        4: DABParams(4, ncarrier2 * nsym, nsym, 3, 72, 6, 2, 3),
    }
    return table[transmission_mode]
