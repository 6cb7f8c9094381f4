"""Character set conversion for DAB labels (ETSI TS 101 756).

Charset ids (table 1): 0 = EBU Latin (annex C repertoire), 4 = ISO 8859-1,
6 = UCS-2 big-endian, 15 = UTF-8.
"""

# ETSI TS 101 756 Annex C: EBU Latin based repertoire, 256 entries.
_EBU_LATIN = (
    "\x00ĘĮŲĂĖĎȘȚĊ\x00\x00ĠĹŻŃ"
    "ąęįųăėďșțċŇĚġĺż\x00"
    " !\"#ł%&'()*+,-./"
    "0123456789:;<=>?"
    "@ABCDEFGHIJKLMNO"
    "PQRSTUVWXYZ[Ů]Ł_"
    "Ąabcdefghijklmno"
    "pqrstuvwxyz«ů»ĽĦ"
    "áàéèíìóòúùÑÇŞß¡Ÿ"
    "âäêëîïôöûüñçşğıÿ"
    "ĶŅ©ĢĞěňőŐ€£$ĀĒĪŪ"
    "ķņĻģļİńűŰ¿ľ°āēīū"
    "ÁÀÉÈÍÌÓÒÚÙŘČŠŽÐĿ"
    "ÂÄÊËÎÏÔÖÛÜřčšžđŀ"
    "ÃÅÆŒŷÝÕØÞŊŔĆŚŹŤð"
    "ãåæœŵýõøþŋŕćśźťħ"
)
assert len(_EBU_LATIN) == 256

EBU_LATIN = 0
ISO_8859_1 = 4
UCS2_BE = 6
UTF8 = 15


def decode_label(buf: bytes, charset: int = EBU_LATIN) -> str:
    """Convert a DAB label byte buffer to a Python string."""
    buf = bytes(buf)
    if charset == EBU_LATIN:
        # control/undefined entries (0x00, 0x0A, 0x0B, 0x1F) produce no
        # output character (TS 101 756 annex C; reference charsets.cpp maps
        # them to empty strings)
        return "".join(_EBU_LATIN[b] for b in buf).replace("\x00", "")
    if charset == ISO_8859_1:
        return buf.decode("latin-1", errors="replace")
    if charset == UCS2_BE:
        return buf.decode("utf-16-be", errors="replace")
    return buf.decode("utf-8", errors="replace")


def abbreviated_label(label_bytes: bytes, flag_field: int, charset: int = EBU_LATIN) -> str:
    """Apply the 16-bit character flag field to build the short label
    (EN 300 401 clause 5.2.2.2)."""
    kept = bytes(b for i, b in enumerate(label_bytes[:16])
                 if flag_field & (1 << (15 - i)))
    return decode_label(kept, charset)
