"""Audio output pipeline: N sources -> mixer -> sink.

Parity surface: reference examples/audio/ (audio_pipeline.{h,cpp},
portaudio_sink, ring_buffer): per-source ring buffer with linear resampling
to the sink rate, float mixing with clipping, pluggable sinks. Sinks: WAV
file, null, and a live ALSA sink (ctypes over libasound, the portaudio
analog) that degrades gracefully on hosts without a sound stack — like
the build image, where only its unavailability path is exercisable.
"""

import struct
import threading
from typing import List

import numpy as np


class AudioSource:
    """One channel's PCM feed with linear resampling to the pipeline rate."""

    def __init__(self, pipeline_rate: int, max_buffer_frames: int = 192000):
        self.pipeline_rate = pipeline_rate
        self.max_buffer_frames = max_buffer_frames
        self._buf = np.zeros((0, 2), dtype=np.float32)
        self._lock = threading.Lock()
        self.muted = False

    def write(self, pcm: np.ndarray, sample_rate: int, channels: int):
        """pcm: int16 interleaved."""
        x = np.asarray(pcm, dtype=np.float32) / 32768.0
        frames = x.reshape(-1, channels)
        if channels == 1:
            frames = np.repeat(frames, 2, axis=1)
        elif channels > 2:
            frames = frames[:, :2]
        if sample_rate != self.pipeline_rate:
            n_in = frames.shape[0]
            n_out = int(n_in * self.pipeline_rate / sample_rate)
            t = np.linspace(0.0, n_in - 1, n_out, dtype=np.float32)
            i0 = np.floor(t).astype(np.int64)
            i1 = np.minimum(i0 + 1, n_in - 1)
            w = (t - i0)[:, None]
            frames = frames[i0] * (1 - w) + frames[i1] * w
        with self._lock:
            self._buf = np.concatenate([self._buf, frames])
            if self._buf.shape[0] > self.max_buffer_frames:
                self._buf = self._buf[-self.max_buffer_frames:]

    def pull(self, nb_frames: int) -> np.ndarray:
        with self._lock:
            take = min(nb_frames, self._buf.shape[0])
            out = np.zeros((nb_frames, 2), dtype=np.float32)
            if take and not self.muted:
                out[:take] = self._buf[:take]
            if take:
                self._buf = self._buf[take:]
        return out


class AudioPipeline:
    def __init__(self, sink=None, sample_rate: int = 48000):
        self.sample_rate = sample_rate
        self.sources: List[AudioSource] = []
        self.sink = sink
        self.volume = 1.0

    def create_source(self) -> AudioSource:
        src = AudioSource(self.sample_rate)
        self.sources.append(src)
        return src

    def mix_block(self, nb_frames: int) -> np.ndarray:
        mix = np.zeros((nb_frames, 2), dtype=np.float32)
        for s in self.sources:
            mix += s.pull(nb_frames)
        return np.clip(mix * self.volume, -1.0, 1.0)

    def run_block(self, nb_frames: int = 4800):
        block = self.mix_block(nb_frames)
        if self.sink is not None:
            self.sink.write_frames(block)
        return block


class NullSink:
    def write_frames(self, frames: np.ndarray):
        pass

    def close(self):
        pass


class AlsaSink:
    """Live playback through ALSA (ctypes over libasound) — the analog of
    the reference's portaudio_sink (examples/audio/portaudio_sink.h:45-77:
    open default device, blocking stream writes, recover on underrun).
    Like host/device.py's rtlsdr wrapper, this degrades gracefully:
    `AlsaSink.is_available()` is False when no libasound/sound hardware
    exists (as in the build image), and construction raises cleanly."""

    @staticmethod
    def _lib():
        import ctypes
        import ctypes.util
        name = ctypes.util.find_library("asound")
        if not name:
            return None
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            return None
        lib.snd_pcm_open.restype = ctypes.c_int
        lib.snd_pcm_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int, ctypes.c_int]
        lib.snd_pcm_set_params.restype = ctypes.c_int
        lib.snd_pcm_set_params.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
            ctypes.c_uint, ctypes.c_int, ctypes.c_uint]
        lib.snd_pcm_writei.restype = ctypes.c_long
        lib.snd_pcm_writei.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_ulong]
        lib.snd_pcm_recover.restype = ctypes.c_int
        lib.snd_pcm_recover.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
        lib.snd_pcm_close.argtypes = [ctypes.c_void_p]
        lib.snd_pcm_drain.argtypes = [ctypes.c_void_p]
        return lib

    @classmethod
    def is_available(cls) -> bool:
        return cls._lib() is not None

    def __init__(self, device: str = "default", sample_rate: int = 48000,
                 latency_us: int = 100000):
        import ctypes
        lib = self._lib()
        if lib is None:
            raise RuntimeError("libasound not available (no sound stack)")
        self._ct = ctypes
        self._alsa = lib
        self._pcm = ctypes.c_void_p()
        # stream=0 playback; format 2 = SND_PCM_FORMAT_S16_LE;
        # access 3 = SND_PCM_ACCESS_RW_INTERLEAVED
        rc = lib.snd_pcm_open(ctypes.byref(self._pcm), device.encode(),
                              0, 0)
        if rc < 0:
            raise RuntimeError(f"snd_pcm_open failed ({rc})")
        rc = lib.snd_pcm_set_params(self._pcm, 2, 3, 2, sample_rate, 1,
                                    latency_us)
        if rc < 0:
            lib.snd_pcm_close(self._pcm)
            raise RuntimeError(f"snd_pcm_set_params failed ({rc})")

    def write_frames(self, frames: np.ndarray):
        frames = np.asarray(frames, np.float32)
        if frames.ndim == 1:                  # mono vector -> stereo frames
            frames = frames.reshape(-1, 1)
        if frames.shape[1] == 1:
            frames = np.repeat(frames, 2, axis=1)
        elif frames.shape[1] > 2:
            frames = frames[:, :2]
        pcm = np.ascontiguousarray(
            np.clip(frames * 32767.0, -32768, 32767).astype("<i2"))
        nb = pcm.shape[0]
        done = 0
        while done < nb:
            chunk = pcm[done:]
            n = self._alsa.snd_pcm_writei(
                self._pcm, chunk.ctypes.data, chunk.shape[0])
            if n < 0:                        # underrun/suspend: recover
                if self._alsa.snd_pcm_recover(self._pcm, int(n), 1) < 0:
                    raise RuntimeError(f"ALSA write failed ({int(n)})")
                continue
            done += int(n)

    def close(self):
        try:
            self._alsa.snd_pcm_drain(self._pcm)
            self._alsa.snd_pcm_close(self._pcm)
        except Exception:
            pass


class WavFileSink:
    """Streaming stereo 16-bit WAV writer with header patch-on-close
    (reference basic_scraper WavFileWriter)."""

    def __init__(self, path: str, sample_rate: int = 48000, channels: int = 2):
        self.path = path
        self.sample_rate = sample_rate
        self.channels = channels
        self._f = open(path, "wb")
        self._data_bytes = 0
        self._write_header()

    def _write_header(self):
        f = self._f
        byte_rate = self.sample_rate * self.channels * 2
        f.seek(0)
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + self._data_bytes))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, self.channels,
                            self.sample_rate, byte_rate,
                            self.channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", self._data_bytes))

    def write_frames(self, frames: np.ndarray):
        pcm = np.clip(frames * 32767.0, -32768, 32767).astype("<i2")
        self._f.seek(44 + self._data_bytes)
        self._f.write(pcm.tobytes())
        self._data_bytes += pcm.nbytes

    def write_pcm16(self, pcm: np.ndarray):
        """Raw interleaved int16 (already at file rate/channels)."""
        pcm = np.asarray(pcm, dtype="<i2")
        self._f.seek(44 + self._data_bytes)
        self._f.write(pcm.tobytes())
        self._data_bytes += pcm.nbytes

    def close(self):
        self._write_header()
        self._f.close()
