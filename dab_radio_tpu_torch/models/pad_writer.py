"""TX-side PAD assembly: dynamic labels and MOT slideshows over X-PAD.

The reference's simulate_transmitter broadcasts random payloads
(examples/simulate_transmitter.cpp:26-41); here the ensemble synthesizer
can carry REAL programme-associated data so the full receive chain —
AAC data_stream_element -> PAD processor -> dynamic label / MOT
assembler -> slideshow manager (dab/pad.py, dab/mot.py,
dab/slideshow.py) — closes the loop against our own transmitter
(reference RX surface: src/dab/pad/pad_processor.cpp,
src/dab/mot/MOT_processor.cpp).

All builders emit (fpad, xpad_reversed) pairs, one per access unit, in
the over-air layout PADProcessor consumes. X-PAD application types per
EN 300 401 7.4.3: 2/3 dynamic-label start/continuation, 12/13 MOT
start/continuation (with a data-group-length indicator prefix, type 1).
"""

from typing import List, Tuple

from ..ops.crc import crc16
from ..dab.pad import CI_LENGTH_TABLE
from ..dab.mot import HEADER, UNSCRAMBLED_BODY

PadField = Tuple[bytes, bytes]            # (fpad, xpad_reversed)


def fpad_for(xpad_len_kind: str, ci_flag: bool) -> bytes:
    """xpad_len_kind: 'short' (0b01) or 'variable' (0b10)."""
    indicator = 0b01 if xpad_len_kind == "short" else 0b10
    b0 = (0 << 6) | (indicator << 4)
    b1 = (int(ci_flag) << 1)
    return bytes([b0, b1])


def label_data_groups(text, charset: int = 0) -> List[bytes]:
    """Dynamic label text -> X-PAD data groups (16-char segments, CRC16).

    Accepts str (must encode to the charset's byte set; pass bytes for
    non-ASCII charsets) up to the DAB maximum of 128 label bytes
    (8 segments x 16 — the 3-bit continuation SegNum field wraps beyond
    that and receivers would assemble a corrupted label)."""
    if isinstance(text, bytes):
        data = text
    else:
        try:
            data = text.encode("ascii")
        except UnicodeEncodeError as e:
            raise ValueError(
                "non-ASCII dynamic label: pre-encode to the target "
                "charset and pass bytes") from e
    if len(data) > 128:
        raise ValueError(f"dynamic label is {len(data)} bytes; "
                         "DAB allows at most 128")
    if not data:
        raise ValueError("empty dynamic label")
    segs = [data[i:i + 16] for i in range(0, len(data), 16)]
    groups = []
    for i, seg in enumerate(segs):
        is_first = i == 0
        is_last = i == len(segs) - 1
        toggle = 1
        b0 = (toggle << 7) | ((int(is_first) << 1 | int(is_last)) << 5) \
            | (0 << 4) | (len(seg) - 1)
        field2 = charset if is_first else i
        b1 = (field2 << 4)
        g = bytes([b0, b1]) + seg
        g += crc16(g).to_bytes(2, "big")
        groups.append(g)
    return groups


def dli_prefix(group_len: int) -> bytes:
    """Data-group-length indicator subfield (X-PAD app type 1)."""
    b = bytes([(group_len >> 8) & 0b111111, group_len & 0xFF])
    return b + crc16(b).to_bytes(2, "big")


def chunk_xpad_fields(payload: bytes, app_start: int, app_cont: int,
                      length_prefix: bytes = b"") -> List[PadField]:
    """Split one data group into variable-size X-PAD subfields with CI
    lists; one (fpad, xpad_reversed) pair per access unit."""
    fields = []
    CHUNK = 48
    pieces = [payload[i:i + CHUNK] for i in range(0, len(payload), CHUNK)]
    for k, piece in enumerate(pieces):
        sub = piece.ljust(CHUNK, b"\x00")
        li = CI_LENGTH_TABLE.index(CHUNK)
        app = app_start if k == 0 else app_cont
        cis = bytearray()
        data = bytearray()
        if k == 0 and length_prefix:
            cis.append((CI_LENGTH_TABLE.index(4) << 5) | 1)
            data += length_prefix.ljust(4, b"\x00")
        cis.append((li << 5) | app)
        if len(cis) < 4:
            cis.append(0)                      # end marker
        xpad = bytes(cis) + bytes(data) + sub
        fields.append((fpad_for("variable", True), bytes(reversed(xpad))))
    return fields


# ---- MOT object assembly (EN 301 234) ----

def build_data_group(dg_type: int, continuity: int, segment_number: int,
                     is_last: bool, tid: int, data: bytes) -> bytes:
    """MSC data group with CRC + session header + transport id."""
    b = bytearray()
    b.append((0 << 7) | (1 << 6) | (1 << 5) | (1 << 4) | (dg_type & 0xF))
    b.append(((continuity & 0xF) << 4) | 0)
    b.append((int(is_last) << 7) | ((segment_number >> 8) & 0x7F))
    b.append(segment_number & 0xFF)
    b.append((1 << 4) | 2)                   # transport id flag, length=2
    b += tid.to_bytes(2, "big")
    b += data
    b += crc16(bytes(b)).to_bytes(2, "big")
    return bytes(b)


def build_mot_segment(dg_type: int, seg_num: int, is_last: bool, tid: int,
                      seg_data: bytes, ci: int = 0) -> bytes:
    payload = bytes([(0 << 5) | ((len(seg_data) >> 8) & 0x1F),
                     len(seg_data) & 0xFF]) + seg_data
    return build_data_group(dg_type, ci, seg_num, is_last, tid, payload)


def build_mot_header(body: bytes, content_name: str = "test.jpg",
                     content_type: int = 2, content_sub: int = 1) -> bytes:
    """MOT header entity: body size, content type/subtype (image: 2;
    jpeg subtype 1, png 3), ContentName extension."""
    name = content_name.encode()
    ext = bytes([(0b11 << 6) | 0b001100, 1 + len(name), 0x00]) + name
    header_size = 7 + len(ext)
    core = bytearray(7)
    core[0] = (len(body) >> 20) & 0xFF
    core[1] = (len(body) >> 12) & 0xFF
    core[2] = (len(body) >> 4) & 0xFF
    core[3] = ((len(body) & 0xF) << 4) | ((header_size >> 9) & 0xF)
    core[4] = (header_size >> 1) & 0xFF
    core[5] = ((header_size & 1) << 7) | ((content_type & 0x3F) << 1) \
        | ((content_sub >> 8) & 1)
    core[6] = content_sub & 0xFF
    return bytes(core) + ext


# ---- high-level: one call -> the per-AU PAD field sequence ----

def dynamic_label_pad_fields(text: str, charset: int = 0) -> List[PadField]:
    fields = []
    for g in label_data_groups(text, charset):
        fields += chunk_xpad_fields(g, 2, 3)
    return fields


def slideshow_pad_fields(image: bytes, name: str = "slide.png",
                         image_type: str = "png", tid: int = 1,
                         seg_size: int = 128) -> List[PadField]:
    """MOT slideshow image -> PAD field sequence (header entity then body
    segments, each data group carried over X-PAD app 12/13 with a DLI)."""
    sub = {"jpeg": 1, "png": 3}[image_type]
    hdr = build_mot_header(image, content_name=name,
                           content_type=2, content_sub=sub)
    groups = [build_mot_segment(HEADER, 0, True, tid, hdr)]
    segs = [image[i:i + seg_size] for i in range(0, len(image), seg_size)]
    for i, s in enumerate(segs):
        groups.append(build_mot_segment(UNSCRAMBLED_BODY, i,
                                        i == len(segs) - 1, tid, s))
    fields = []
    for g in groups:
        fields += chunk_xpad_fields(g, 12, 13, length_prefix=dli_prefix(len(g)))
    return fields
