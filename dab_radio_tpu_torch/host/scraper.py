"""Disk scraper: writes decoded channel output into a per-service directory
tree.

Parity surface: reference src/basic_scraper/ (basic_scraper.{h,cpp}):
service_<sid>/component_<id>/ directories containing WAV audio (patched
header on close), raw AAC (ADTS) / MP2 bitstreams, slideshow images, and MOT
entities.
"""

import os
from typing import Dict, Optional

import numpy as np

from .audio import WavFileSink
from ..dab.aac import adts_header


class ChannelScraper:
    def __init__(self, root: str, subchannel_id: int, kind: str,
                 dirname: str = None):
        # reference tree: service_<sid:X>_component_<cid:X>
        # (basic_scraper.cpp:63); subchannel_<id> when the component is not
        # yet in the database
        self.dir = os.path.join(root,
                                dirname or f"subchannel_{subchannel_id}")
        os.makedirs(self.dir, exist_ok=True)
        self.kind = kind
        self._wav: Optional[WavFileSink] = None
        self._wav_params = None
        self._bitstream = None
        self._slideshow_count = 0
        self._mot_count = 0

    # ---- audio ----

    def on_pcm(self, pcm: np.ndarray, sample_rate: int, channels: int):
        params = (sample_rate, channels)
        if self._wav is None or self._wav_params != params:
            if self._wav is not None:
                self._wav.close()
            idx = 0 if self._wav is None else 1
            path = os.path.join(self.dir, f"audio_{sample_rate}hz.wav")
            self._wav = WavFileSink(path, sample_rate, channels)
            self._wav_params = params
        self._wav.write_pcm16(pcm)

    def on_access_unit(self, index, total, au, header):
        if self._bitstream is None:
            ext = "aac" if self.kind == "dab+" else "mp2"
            self._bitstream = open(os.path.join(self.dir, f"stream.{ext}"), "wb")
        if self.kind == "dab+":
            self._bitstream.write(adts_header(header, len(au)))
        self._bitstream.write(au)

    def on_mp2_frame(self, frame: bytes):
        if self._bitstream is None:
            self._bitstream = open(os.path.join(self.dir, "stream.mp2"), "wb")
        self._bitstream.write(frame)

    # ---- data ----

    def on_slideshow(self, slideshow):
        name = slideshow.name or f"slide_{self._slideshow_count}"
        name = name.replace("/", "_")
        if not name.lower().endswith((".jpg", ".jpeg", ".png")):
            name += "." + ("jpg" if slideshow.image_type == "jpeg" else "png")
        with open(os.path.join(self.dir, name), "wb") as f:
            f.write(slideshow.data)
        self._slideshow_count += 1

    def on_mot_entity(self, entity):
        name = entity.header.content_name or f"mot_{self._mot_count}"
        name = name.replace("/", "_")
        with open(os.path.join(self.dir, name), "wb") as f:
            f.write(entity.body)
        self._mot_count += 1

    def on_dynamic_label(self, label: str):
        with open(os.path.join(self.dir, "labels.txt"), "a") as f:
            f.write(label + "\n")

    def close(self):
        if self._wav is not None:
            self._wav.close()
        if self._bitstream is not None:
            self._bitstream.close()


class Scraper:
    """Attach to a DabReceiver; creates per-channel scrapers as channels
    appear (reference BasicScraper::attach_to_radio)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.channels: Dict[int, ChannelScraper] = {}

    def attach(self, receiver):
        self._receiver = receiver
        receiver.on_audio_channel.append(self._on_channel)
        receiver.on_data_channel.append(self._on_channel)
        # channels may already exist (snapshot restore): hook them now
        for sub_id, ch in receiver.channels.items():
            self._on_channel(sub_id, ch)

    def _dirname(self, sub_id: int):
        rx = getattr(self, "_receiver", None)
        if rx is None:
            return None
        comp = rx.db.component_by_subchannel(sub_id)
        if comp is None:
            return None
        return f"service_{comp.service_id:X}_component_{comp.component_id:X}"

    def _on_channel(self, sub_id: int, ch):
        cs = ChannelScraper(self.root, sub_id, ch.kind,
                            dirname=self._dirname(sub_id))
        self.channels[sub_id] = cs
        if ch.kind == "dab+":
            ch.events.on_access_unit.append(cs.on_access_unit)
            ch.events.on_dynamic_label.append(cs.on_dynamic_label)
            ch.events.on_audio_data.append(cs.on_pcm)
            ch.slideshows.on_slideshow.append(cs.on_slideshow)
        elif ch.kind == "dab":
            ch.events.on_frame_data.append(cs.on_mp2_frame)
            ch.events.on_dynamic_label.append(cs.on_dynamic_label)
            ch.events.on_audio_data.append(cs.on_pcm)
            ch.slideshows.on_slideshow.append(cs.on_slideshow)
        elif ch.kind == "packet":
            ch.processor.mot.on_entity.append(cs.on_mot_entity)

    def close(self):
        for cs in self.channels.values():
            cs.close()


class FleetScraper:
    """Serving-path scraper: attach to a FusedFleet — one ChannelScraper
    per (stream, subchannel) under root/stream_<b>/subchannel_<s>.

    The fused byte layer ships bitstreams downstream without X-PAD
    decode, so dynamic labels / PAD slideshows are not scraped here (use
    the dynamic path for those); what lands on disk: per-subchannel
    AAC(ADTS)/MP2 bitstreams, MOT entities from packet-mode subchannels,
    and WAV audio for channels enabled via FusedFleet.enable_audio."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.channels: Dict[tuple, ChannelScraper] = {}

    def attach(self, fleet):
        for b in range(fleet.N):
            for s in range(fleet.S):
                k = fleet._kinds[b][s]
                kind = {"audio": "dab+", "mp2": "dab"}.get(k, "packet") \
                    if not isinstance(k, tuple) else "packet"
                cs = ChannelScraper(
                    os.path.join(self.root, f"stream_{b}"), s, kind)
                self.channels[(b, s)] = cs
                if kind == "packet":
                    fleet._sfp[b][s].mot.on_entity.append(cs.on_mot_entity)
        fleet.on_access_unit.append(
            lambda b, s, i, n, au, hdr:
            self.channels[(b, s)].on_access_unit(i, n, au, hdr))
        fleet.on_mp2_frame.append(
            lambda b, s, frame: self.channels[(b, s)].on_mp2_frame(frame))
        fleet.on_audio_data.append(
            lambda b, s, pcm, rate, nch:
            self.channels[(b, s)].on_pcm(pcm, rate, nch))

    def close(self):
        for cs in self.channels.values():
            cs.close()
