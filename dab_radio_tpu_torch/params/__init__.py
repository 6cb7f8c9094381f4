"""Static DAB parameter tables (ETSI EN 300 401) as NumPy arrays.

Everything here is pure host-side table generation: OFDM transmission-mode
geometry, phase-reference-symbol (PRS) spectra, the frequency-interleaver
carrier map, convolutional puncture vectors, and UEP/EEP subchannel protection
profiles. These feed the tensor ops with precomputed constant arrays.
A copy of ``dab_radio_tpu/params``, kept here so that this package stands alone.
"""

from .ofdm import OFDMParams, get_ofdm_params, DABParams, get_dab_params
from .prs import get_prs_reference
from .mapper import get_carrier_mapper
from .puncture import (
    get_puncture_vector,
    PI_X_VECTOR,
    build_depuncture_gather,
    fic_puncture_schedule,
)
from .protection import (
    UEPProfile,
    EEPProfile,
    get_uep_profile,
    get_eep_profile,
    eep_bitrate_kbps,
    uep_find_index,
    msc_puncture_schedule,
    SubchannelConfig,
)
