"""DAB ensemble database with conflict-tracking updaters.

Mirror of the reference's entity store + updater layer
(src/dab/database/dab_database_entities.h, dab_database_updater.{h,cpp}):
plain entities whose fields are merged from repeated FIG events with
dirty-field tracking, per-field conflict counting (contradictory FIGs never
crash the decoder), completion predicates over required fields, and a global
statistics tuple that doubles as a cheap change detector for the radio
orchestration layer.
"""

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

from . import fig as F

# ---- mutation clock ---------------------------------------------------------
#
# A module-level counter that advances on every REAL change to any database
# entity (field set to a different value, guarded list append, entity
# creation). `DabReceiver.ingest_fibs` uses it to prove a carousel FIB's
# application was a no-op against the current database state before
# memoizing it — applying a FIB can silently do nothing when a FIG it
# references hasn't arrived yet (e.g. FIG 0/13 user-app before the FIG 0/2
# packet ref that links the component to its service), and only the
# carousel's re-application converges the database; a value-blind memo
# breaks that. Pickle restore bypasses __setattr__ (no spurious bumps).

_DB_MUTATION_CLOCK = [0]


def db_mutation_clock() -> int:
    return _DB_MUTATION_CLOCK[0]


def _bump() -> None:
    _DB_MUTATION_CLOCK[0] += 1


def _getdefault(d, key, factory):
    """dict.setdefault semantics without eagerly constructing the default:
    building a _Tracked entity bumps the mutation clock in __init__, so an
    eager default would count a pure lookup (e.g. every carousel
    repetition of FIG 0/6/0/21/0/24) as a database change and permanently
    defeat the FIB memo."""
    e = d.get(key)
    if e is None:
        e = d[key] = factory()
    return e


_UNSET = object()


class _Tracked:
    """Entity base: advance the mutation clock when a field actually changes.

    Dataclass __init__ runs through here too, so entity creation counts as
    a mutation (each field goes missing -> value)."""

    def __setattr__(self, name, value):
        if getattr(self, name, _UNSET) != value:
            _bump()
        object.__setattr__(self, name, value)

# transport modes
STREAM_AUDIO, STREAM_DATA, PACKET_DATA = 0, 1, 3
# audio service types (ASCTy)
AUDIO_DAB, AUDIO_DAB_PLUS = 0, 63
# data service types (DSCTy)
DATA_TRANSPARENT, DATA_MPEG2, DATA_MOT, DATA_PROPRIETARY = 5, 24, 60, 63
# FEC schemes for packet mode
FEC_NONE, FEC_REED_SOLOMON = 0, 1


@dataclass
class Ensemble(_Tracked):
    id: int = 0
    extended_country_code: int = 0
    label: str = ""
    short_label: str = ""
    nb_services: int = 0
    reconfiguration_count: int = 0
    local_time_offset: int = 0          # in half-hours, sign bit applied
    international_table_id: int = 0
    has_international_table: bool = False
    is_complete: bool = False


@dataclass
class Service(_Tracked):
    id: int = 0
    country_id: int = 0
    extended_country_code: int = 0
    label: str = ""
    short_label: str = ""
    programme_type: int = 0
    language: int = 0
    is_complete: bool = False


@dataclass
class ServiceComponent(_Tracked):
    service_id: int = 0
    component_id: int = 0               # SCIdS
    global_id: Optional[int] = None     # SCId (packet components)
    subchannel_id: Optional[int] = None
    transport_mode: Optional[int] = None
    audio_service_type: Optional[int] = None
    data_service_type: Optional[int] = None
    packet_address: Optional[int] = None
    dg_flag: int = 0
    is_primary: bool = False
    label: str = ""
    short_label: str = ""
    language: int = 0
    user_app_types: List[int] = dc_field(default_factory=list)
    is_complete: bool = False


@dataclass
class Subchannel(_Tracked):
    id: int = 0
    start_address: Optional[int] = None
    length: Optional[int] = None        # capacity units
    is_uep: Optional[bool] = None
    uep_table_index: Optional[int] = None
    eep_type: Optional[str] = None      # 'A' | 'B'
    eep_prot_level: Optional[int] = None
    fec_scheme: Optional[int] = None
    is_complete: bool = False


@dataclass
class LinkService(_Tracked):
    id: int = 0                          # linkage set number
    is_active_link: bool = False
    is_hard_link: bool = False
    is_international: bool = False
    service_ids: List[int] = dc_field(default_factory=list)
    fm_services: List[int] = dc_field(default_factory=list)
    drm_services: List[int] = dc_field(default_factory=list)
    is_complete: bool = False


@dataclass
class OtherEnsemble(_Tracked):
    ensemble_id: int = 0
    frequency_hz: int = 0
    is_continuous: bool = False
    is_geo_adjacent: bool = False
    is_mode_one: bool = False
    service_ids: List[int] = dc_field(default_factory=list)
    is_complete: bool = False


@dataclass
class FMService(_Tracked):
    """FM station linked to a DAB service (reference FM_Service)."""
    pi_code: int = 0
    lsn: Optional[int] = None
    is_time_compensated: bool = False
    frequencies: List[int] = dc_field(default_factory=list)
    is_complete: bool = False


@dataclass
class DRMService(_Tracked):
    drm_id: int = 0
    lsn: Optional[int] = None
    is_time_compensated: bool = False
    frequencies: List[int] = dc_field(default_factory=list)
    is_complete: bool = False


@dataclass
class AMSSService(_Tracked):
    amss_id: int = 0
    is_time_compensated: bool = False
    frequencies: List[int] = dc_field(default_factory=list)
    is_complete: bool = False


@dataclass
class MiscInfo:
    """Non-database FIC info: CIF counter + datetime (reference
    DAB_Misc_Info)."""
    cif_upper: int = 0
    cif_lower: int = 0
    mjd: int = 0
    hours: int = 0
    minutes: int = 0
    seconds: int = 0
    milliseconds: int = 0


Stats = Tuple[int, int, int, int]       # (total, completed, conflicts, updates)


class DabDatabase:
    def __init__(self):
        self.ensemble = Ensemble()
        self.services: Dict[int, Service] = {}
        self.service_components: List[ServiceComponent] = []
        self.subchannels: Dict[int, Subchannel] = {}
        self.link_services: Dict[int, LinkService] = {}
        self.other_ensembles: Dict[int, OtherEnsemble] = {}
        self.fm_services: Dict[int, FMService] = {}
        self.drm_services: Dict[int, DRMService] = {}
        self.amss_services: Dict[int, AMSSService] = {}

    def component_by_subchannel(self, subchannel_id: int) -> Optional[ServiceComponent]:
        for c in self.service_components:
            if c.subchannel_id == subchannel_id:
                return c
        return None


class DatabaseUpdater:
    """Applies FIG events into the database; tracks conflicts and completion.

    set-once merge: the first value wins; a differing later value bumps the
    conflict counter (reference DatabaseEntityUpdater semantics)."""

    def __init__(self):
        self.db = DabDatabase()
        self.misc = MiscInfo()
        self.conflicts = 0
        self.updates = 0

    # ---- statistics / change detection ----

    def stats(self) -> Stats:
        total = (1 + len(self.db.services) + len(self.db.service_components)
                 + len(self.db.subchannels) + len(self.db.link_services)
                 + len(self.db.other_ensembles))
        completed = sum([
            self.db.ensemble.is_complete,
            *(s.is_complete for s in self.db.services.values()),
            *(c.is_complete for c in self.db.service_components),
            *(s.is_complete for s in self.db.subchannels.values()),
        ])
        return (total, completed, self.conflicts, self.updates)

    # ---- merge helper ----

    def _set(self, obj, name, value):
        cur = getattr(obj, name)
        if cur is None or cur == "" or cur == 0 or cur is False:
            setattr(obj, name, value)
            self.updates += 1
        elif cur != value:
            self.conflicts += 1

    # ---- entity lookups ----

    def _service(self, sid: int) -> Service:
        if sid not in self.db.services:
            self.db.services[sid] = Service(id=sid, is_complete=True)
        return self.db.services[sid]

    def _subchannel(self, sub_id: int) -> Subchannel:
        if sub_id not in self.db.subchannels:
            self.db.subchannels[sub_id] = Subchannel(id=sub_id)
        return self.db.subchannels[sub_id]

    def _component_stream(self, sid: int, sub_id: int) -> ServiceComponent:
        for c in self.db.service_components:
            if c.service_id == sid and c.subchannel_id == sub_id:
                return c
        c = ServiceComponent(service_id=sid, subchannel_id=sub_id)
        self.db.service_components.append(c)
        return c

    def _component_packet(self, scid: int, sid: Optional[int] = None) -> ServiceComponent:
        for c in self.db.service_components:
            if c.global_id == scid:
                if sid is not None and c.service_id == 0:
                    c.service_id = sid
                return c
        c = ServiceComponent(service_id=sid or 0, global_id=scid)
        self.db.service_components.append(c)
        return c

    # ---- completion ----

    @staticmethod
    def _update_component_complete(c: ServiceComponent):
        if c.transport_mode == STREAM_AUDIO:
            c.is_complete = (c.subchannel_id is not None
                             and c.audio_service_type is not None)
        elif c.transport_mode == STREAM_DATA:
            c.is_complete = (c.subchannel_id is not None
                             and c.data_service_type is not None)
        elif c.transport_mode == PACKET_DATA:
            # reference additionally requires a user application type
            # (SERVICE_COMPONENT_FLAG_REQUIRED_PACKET_DATA includes
            # APPLICATION_TYPE) — real broadcasters announce it via FIG 0/13
            c.is_complete = (c.subchannel_id is not None
                             and c.data_service_type is not None
                             and c.packet_address is not None
                             and len(c.user_app_types) > 0)
        else:
            c.is_complete = False

    @staticmethod
    def _update_subchannel_complete(s: Subchannel):
        prot_ok = ((s.is_uep is True and s.uep_table_index is not None) or
                   (s.is_uep is False and s.eep_type is not None
                    and s.eep_prot_level is not None))
        s.is_complete = (s.start_address is not None and s.length is not None
                         and prot_ok)

    # ---- event application ----

    def apply(self, ev) -> None:
        self.updates += 1
        if isinstance(ev, F.EnsembleInfo):
            self._set(self.db.ensemble, "id", ev.ensemble_id)
            # reference ENSEMBLE_FLAG_REQUIRED = ID | INTER_TABLE (0/9)
            self.db.ensemble.is_complete = \
                self.db.ensemble.has_international_table
            self.misc.cif_upper = ev.cif_upper
            self.misc.cif_lower = ev.cif_lower
        elif isinstance(ev, F.SubchannelShort):
            s = self._subchannel(ev.subchannel_id)
            self._set(s, "start_address", ev.start_address)
            if s.is_uep is None:
                s.is_uep = True
            self._set(s, "uep_table_index", ev.table_index)
            from ..params.protection import UEP_TABLE
            if ev.table_index < len(UEP_TABLE):
                self._set(s, "length", UEP_TABLE[ev.table_index].subchannel_size)
            self._update_subchannel_complete(s)
        elif isinstance(ev, F.SubchannelLong):
            s = self._subchannel(ev.subchannel_id)
            self._set(s, "start_address", ev.start_address)
            if s.is_uep is None:
                s.is_uep = False
            self._set(s, "eep_type", "A" if ev.option == 0 else "B")
            if s.eep_prot_level is None:
                s.eep_prot_level = ev.prot_level
                self.updates += 1
            self._set(s, "length", ev.subchannel_size)
            self._update_subchannel_complete(s)
        elif isinstance(ev, F.StreamComponent):
            self._service(ev.service_id)
            c = self._component_stream(ev.service_id, ev.subchannel_id)
            c.transport_mode = STREAM_AUDIO if ev.is_audio else STREAM_DATA
            if ev.is_audio:
                c.audio_service_type = ev.ty
            else:
                c.data_service_type = ev.ty
            c.is_primary = ev.is_primary
            self._update_component_complete(c)
        elif isinstance(ev, F.PacketComponentRef):
            self._service(ev.service_id)
            c = self._component_packet(ev.scid, ev.service_id)
            c.transport_mode = PACKET_DATA
            c.is_primary = ev.is_primary
            self._update_component_complete(c)
        elif isinstance(ev, F.PacketComponent):
            c = self._component_packet(ev.scid)
            c.transport_mode = PACKET_DATA
            if c.subchannel_id is None:
                c.subchannel_id = ev.subchannel_id
            c.data_service_type = ev.dscty
            c.packet_address = ev.packet_address
            c.dg_flag = ev.dg_flag
            self._update_component_complete(c)
        elif isinstance(ev, F.ComponentGlobalDefinition):
            if ev.subchannel_id is not None:
                c = self._component_stream(ev.service_id, ev.subchannel_id)
            else:
                c = self._component_packet(ev.scid, ev.service_id)
            c.component_id = ev.scids
            self._update_component_complete(c)
        elif isinstance(ev, F.ComponentLanguage):
            if ev.subchannel_id is not None:
                c = self.db.component_by_subchannel(ev.subchannel_id)
            else:
                c = self._component_packet(ev.scid)
            if c is not None:
                c.language = ev.language
        elif isinstance(ev, F.StreamCA):
            pass                      # conditional access not decoded
        elif isinstance(ev, F.ServiceLinkage):
            ls = _getdefault(self.db.link_services, ev.lsn,
                     lambda: LinkService(id=ev.lsn))
            ls.is_active_link = ev.is_active_link
            ls.is_hard_link = ev.is_hard_link
            ls.is_international = ev.is_international
            for sid in ev.service_ids:
                if sid not in ls.service_ids:
                    ls.service_ids.append(sid)
                    _bump()
            for pid in ev.rds_pi_ids:
                if pid not in ls.fm_services:
                    ls.fm_services.append(pid)
                    _bump()
                fm = _getdefault(self.db.fm_services, pid,
                     lambda: FMService(pi_code=pid))
                if fm.lsn is None:
                    fm.lsn = ev.lsn
                fm.is_complete = bool(fm.frequencies)
            for did in ev.drm_ids:
                if did not in ls.drm_services:
                    ls.drm_services.append(did)
                    _bump()
                dr = _getdefault(self.db.drm_services, did,
                     lambda: DRMService(drm_id=did))
                if dr.lsn is None:
                    dr.lsn = ev.lsn
                dr.is_complete = bool(dr.frequencies)
            # reference LINK_FLAG_REQUIRED = SERVICE_ID: complete only once
            # a DAB service id is linked
            ls.is_complete = bool(ls.service_ids)
        elif isinstance(ev, F.ConfigurationInfo):
            self.db.ensemble.nb_services = ev.nb_services
            self.db.ensemble.reconfiguration_count = ev.reconfiguration_count
        elif isinstance(ev, F.EnsembleCountry):
            lto = ev.lto
            hours_half = lto & 0b11111
            self.db.ensemble.local_time_offset = (
                -hours_half if (lto >> 5) & 1 else hours_half)
            self._set(self.db.ensemble, "extended_country_code", ev.ecc)
            self._set(self.db.ensemble, "international_table_id",
                      ev.international_table_id)
            self.db.ensemble.has_international_table = True
            if self.db.ensemble.id:
                self.db.ensemble.is_complete = True
            for sid in ev.service_ids:
                self._service(sid)
        elif isinstance(ev, F.DateTime):
            self.misc.mjd = ev.mjd
            self.misc.hours, self.misc.minutes = ev.hours, ev.minutes
            self.misc.seconds, self.misc.milliseconds = ev.seconds, ev.milliseconds
        elif isinstance(ev, F.UserApplication):
            for c in self.db.service_components:
                if c.service_id == ev.service_id and c.component_id == ev.scids:
                    if ev.app_type not in c.user_app_types:
                        c.user_app_types.append(ev.app_type)
                        _bump()
                    self._update_component_complete(c)
                    break
        elif isinstance(ev, F.SubchannelFEC):
            s = self._subchannel(ev.subchannel_id)
            if s.fec_scheme is None:
                s.fec_scheme = ev.fec_scheme
        elif isinstance(ev, F.ProgrammeType):
            sv = self._service(ev.service_id)
            sv.programme_type = ev.international_code
            if ev.language_type:
                sv.language = ev.language_type
        elif isinstance(ev, F.FrequencyInfo):
            if ev.rm == 0:
                oe = _getdefault(self.db.other_ensembles, ev.id_value,
                     lambda: OtherEnsemble(ensemble_id=ev.id_value))
                oe.frequency_hz = ev.frequency_hz
                oe.is_continuous = ev.is_continuous
                oe.is_geo_adjacent = ev.geo_adjacent
                oe.is_mode_one = ev.mode_one
                oe.is_complete = True
            elif ev.rm == 0b1000:
                fm = _getdefault(self.db.fm_services, ev.id_value,
                     lambda: FMService(pi_code=ev.id_value))
                fm.is_time_compensated = ev.is_continuous
                if ev.frequency_hz not in fm.frequencies:
                    fm.frequencies.append(ev.frequency_hz)
                    _bump()
                fm.is_complete = fm.lsn is not None
            elif ev.rm == 0b0110:
                dr = _getdefault(self.db.drm_services, ev.id_value,
                     lambda: DRMService(drm_id=ev.id_value))
                dr.is_time_compensated = ev.is_continuous
                if ev.frequency_hz not in dr.frequencies:
                    dr.frequencies.append(ev.frequency_hz)
                    _bump()
                dr.is_complete = dr.lsn is not None
            elif ev.rm == 0b1110:
                am = _getdefault(self.db.amss_services, ev.id_value,
                     lambda: AMSSService(amss_id=ev.id_value))
                am.is_time_compensated = ev.is_continuous
                if ev.frequency_hz not in am.frequencies:
                    am.frequencies.append(ev.frequency_hz)
                    _bump()
                am.is_complete = True
        elif isinstance(ev, F.OtherEnsembleService):
            oe = _getdefault(self.db.other_ensembles, ev.ensemble_id,
                     lambda: OtherEnsemble(ensemble_id=ev.ensemble_id))
            if ev.service_id not in oe.service_ids:
                oe.service_ids.append(ev.service_id)
                _bump()
            # reference OE completeness requires the frequency (0/21 rm=0);
            # 0/24 alone only creates the entity
        elif isinstance(ev, F.Label):
            if ev.kind == "ensemble":
                self._set(self.db.ensemble, "label", ev.label)
                self._set(self.db.ensemble, "short_label", ev.short_label)
            elif ev.kind == "service":
                sv = self._service(ev.id_value)
                self._set(sv, "label", ev.label)
                self._set(sv, "short_label", ev.short_label)
                # fig 1/4 note: the primary component (SCIdS 0) carries the
                # service label (reference radio_fig_handler.cpp:582-585,
                # creating the component if it doesn't exist yet)
                for c in self.db.service_components:
                    if c.service_id == ev.id_value and c.component_id == 0:
                        c.label, c.short_label = ev.label, ev.short_label
                        break
                else:
                    c = ServiceComponent(service_id=ev.id_value,
                                         label=ev.label,
                                         short_label=ev.short_label)
                    self.db.service_components.append(c)
            elif ev.kind == "component":
                for c in self.db.service_components:
                    if (c.service_id == ev.id_value
                            and c.component_id == (ev.scids or 0)):
                        c.label, c.short_label = ev.label, ev.short_label
                        break
