"""Per-channel audio control flags.

Parity surface: reference src/basic_radio/basic_audio_controls.{h,cpp}:5-65 —
three flags (decode-audio, decode-data, play-audio) with implication rules:
disabling audio decode forces playback off; enabling playback forces audio
decode on. `run_all`/`stop_all` flip every flag at once (the reference's
benchmark mode uses run_all on every discovered channel).

Defaults differ deliberately from the reference (which starts all-off until
the user selects a channel in the GUI): our channels start with decode_data
on so PAD/dynamic-label/slideshow decode — pure host byte-work — is always
live, matching how the CLI apps here enable every discovered channel.
"""


class AudioControls:
    __slots__ = ("_decode_audio", "_decode_data", "_play_audio")

    def __init__(self, decode_audio=False, decode_data=True, play_audio=False):
        self._decode_audio = bool(decode_audio)
        self._decode_data = bool(decode_data)
        self._play_audio = bool(play_audio)
        if self._play_audio:
            self._decode_audio = True

    # ---- decode AAC/MP2 audio elements to PCM ----
    @property
    def decode_audio(self) -> bool:
        return self._decode_audio

    @decode_audio.setter
    def decode_audio(self, v: bool):
        self._decode_audio = bool(v)
        if not v:
            self._play_audio = False

    # ---- decode PAD / data_stream_element ----
    @property
    def decode_data(self) -> bool:
        return self._decode_data

    @decode_data.setter
    def decode_data(self, v: bool):
        self._decode_data = bool(v)

    # ---- route decoded PCM to the audio sink ----
    @property
    def play_audio(self) -> bool:
        return self._play_audio

    @play_audio.setter
    def play_audio(self, v: bool):
        self._play_audio = bool(v)
        if v:
            self._decode_audio = True

    @property
    def any_enabled(self) -> bool:
        return self._decode_audio or self._decode_data or self._play_audio

    @property
    def all_enabled(self) -> bool:
        return self._decode_audio and self._decode_data and self._play_audio

    def run_all(self):
        self._decode_audio = self._decode_data = self._play_audio = True

    def stop_all(self):
        self._decode_audio = self._decode_data = self._play_audio = False

    def __repr__(self):
        return (f"AudioControls(decode_audio={self._decode_audio}, "
                f"decode_data={self._decode_data}, "
                f"play_audio={self._play_audio})")
