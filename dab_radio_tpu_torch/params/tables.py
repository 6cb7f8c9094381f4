"""Human-readable lookup tables (ETSI TS 101 756): programme types,
languages, country ids — complete transcriptions, golden-tested against the
reference's tables (tests/test_golden_reference.py).

Parity surface: reference src/dab/constants/{programme_type_table.h,
language_table.h, country_table.h}. Programme types use international table
id 1 (Europe) / 2 (North America) and carry (long, short) label pairs;
languages are tables 9/10 (a few reference spellings, e.g. "Ukranian", are
kept verbatim for parity); countries key on (extended country code, country
id nibble) with the reference's first-entry-wins rule for codes ETSI
assigns to several territories (e.g. E1-9 Denmark/Faroe).
"""

# Table 12: programme types, international table 1 (Europe);
# (long_label, short_label) pairs
PROGRAMME_TYPES_EU = [
    ('None', 'None'), ('News', 'News'), ('Current Affairs', 'Affairs'),
    ('Information', 'Info'), ('Sport', 'Sport'), ('Education', 'Educate'),
    ('Drama', 'Drama'), ('Arts', 'Arts'), ('Science', 'Science'),
    ('Talk', 'Talk'), ('Pop Music', 'Pop'), ('Rock Music', 'Rock'),
    ('Easy Listening', 'Easy'), ('Light Classical', 'Classics'),
    ('Classical Music', 'Classics'), ('Music', 'Music'),
    ('Weather', 'Weather'), ('Finance', 'Finance'),
    ("Children's", 'Children'), ('Factual', 'Factual'),
    ('Religion', 'Religion'), ('Phone In', 'Phone In'), ('Travel', 'Travel'),
    ('Leisure', 'Leisure'), ('Jazz and Blues', 'Jazz'),
    ('Country Music', 'Country'), ('National Music', 'Nation M'),
    ('Oldies Music', 'Oldies'), ('Folk Music', 'Folk'),
    ('Documentary', 'Document'), ('Not used', 'Not used'),
    ('Not used', 'Not used'),
]

# international table 2 (North America)
PROGRAMME_TYPES_NA = [
    ('None', 'None'), ('News', 'News'), ('Information', 'Inform'),
    ('Sports', 'Sports'), ('Talk', 'Talk'), ('Rock', 'Rock'),
    ('Classic Rock', 'Cls Rock'), ('Adult Hits', 'Adlt Hit'),
    ('Soft_Rock', 'Soft_Rck'), ('Top 40', 'Top 40'), ('Country', 'Country'),
    ('Oldies', 'Oldies'), ('Soft', 'Soft'), ('Nostalgia', 'Nostalga'),
    ('Jazz', 'Jazz'), ('Classical', 'Classical'), ('Rhythm and Blue', 'R&B'),
    ('Soft Rhythm and Blues', 'Soft R&B'), ('Foreign Language', 'Language'),
    ('Religious Music', 'Rel Musc'), ('Religious Talk', 'Rel Talk'),
    ('Personality', 'Persnlty'), ('Public', 'Public'), ('College', 'College'),
    ('RFU', 'RFU'), ('RFU', 'RFU'), ('RFU', 'RFU'), ('RFU', 'RFU'),
    ('RFU', 'RFU'), ('Weather', 'Weather'), ('Not used', 'Not used'),
    ('Not used', 'Not used'),
]


def programme_type_label(code: int, international_table_id: int = 1,
                         short: bool = False) -> str:
    table = (PROGRAMME_TYPES_NA if international_table_id == 2
             else PROGRAMME_TYPES_EU)
    if not 0 <= code < len(table):
        return ""
    return table[code][1 if short else 0]


# Tables 9+10: language codes (complete, incl. RFU/reserved rows)
LANGUAGES = {
    0x00: "Unknown", 0x01: "Albanian", 0x02: "Breton", 0x03: "Catalan",
    0x04: "Croatian", 0x05: "Welsh", 0x06: "Czech", 0x07: "Danish",
    0x08: "German", 0x09: "English", 0x0A: "Spanish", 0x0B: "Esperanto",
    0x0C: "Estonian", 0x0D: "Basque", 0x0E: "Faroese", 0x0F: "French",
    0x10: "Frisian", 0x11: "Irish", 0x12: "Gaelic", 0x13: "Galician",
    0x14: "Icelandic", 0x15: "Italian", 0x16: "Sami", 0x17: "Latin",
    0x18: "Latvian", 0x19: "Luxembourgian", 0x1A: "Lithuanian",
    0x1B: "Hungarian", 0x1C: "Maltese", 0x1D: "Dutch", 0x1E: "Norwegian",
    0x1F: "Occitan", 0x20: "Polish", 0x21: "Portuguese", 0x22: "Romanian",
    0x23: "Romansh", 0x24: "Serbian", 0x25: "Slovak", 0x26: "Slovene",
    0x27: "Finnish", 0x28: "Swedish", 0x29: "Turkish", 0x2A: "Flemish",
    0x2B: "Walloon", 0x2C: "RFU", 0x2D: "RFU", 0x2E: "RFU", 0x2F: "RFU",
    0x30: "Reserved national", 0x31: "Reserved national",
    0x32: "Reserved national", 0x33: "Reserved national",
    0x34: "Reserved national", 0x35: "Reserved national",
    0x36: "Reserved national", 0x37: "Reserved national",
    0x38: "Reserved national", 0x39: "Reserved national",
    0x3A: "Reserved national", 0x3B: "Reserved national",
    0x3C: "Reserved national", 0x3D: "Reserved national",
    0x3E: "Reserved national", 0x3F: "Reserved national",
    0x40: "Background sound/clean feed", 0x41: "rfu", 0x42: "rfu",
    0x43: "rfu", 0x44: "rfu", 0x45: "Zulu", 0x46: "Vietnamese", 0x47: "Uzbek",
    0x48: "Urdu", 0x49: "Ukranian", 0x4A: "Thai", 0x4B: "Telugu",
    0x4C: "Tatar", 0x4D: "Tamil", 0x4E: "Tadzhik", 0x4F: "Swahili",
    0x50: "Sranan Tongo", 0x51: "Somali", 0x52: "Sinhalese", 0x53: "Shona",
    0x54: "Serbo-Croat", 0x55: "Rusyn", 0x56: "Russian", 0x57: "Quechua",
    0x58: "Pushtu", 0x59: "Punjabi", 0x5A: "Persian", 0x5B: "Papiamento",
    0x5C: "Oriya", 0x5D: "Nepali", 0x5E: "Ndebele", 0x5F: "Marathi",
    0x60: "Moldavian", 0x61: "Malaysian", 0x62: "Malagasay",
    0x63: "Macedonian", 0x64: "Laotian", 0x65: "Korean", 0x66: "Khmer",
    0x67: "Kazakh", 0x68: "Kannada", 0x69: "Japanese", 0x6A: "Indonesian",
    0x6B: "Hindi", 0x6C: "Hebrew", 0x6D: "Hausa", 0x6E: "Gurani",
    0x6F: "Gujurati", 0x70: "Greek", 0x71: "Georgian", 0x72: "Fulani",
    0x73: "Dari", 0x74: "Chuvash", 0x75: "Chinese", 0x76: "Burmese",
    0x77: "Bulgarian", 0x78: "Bengali", 0x79: "Belorussian", 0x7A: "Bambora",
    0x7B: "Azerbaijani", 0x7C: "Assamese", 0x7D: "Armenian", 0x7E: "Arabic",
    0x7F: "Amharic",
}


def language_label(code: int) -> str:
    return LANGUAGES.get(code, f"0x{code:02X}")


# Annex tables 3-7: country ids keyed by (ECC, country id nibble)
COUNTRIES = {
    (0xE0, 0x1): "Germany", (0xE0, 0x2): "Algeria", (0xE0, 0x3): "Andorra",
    (0xE0, 0x4): "Israel", (0xE0, 0x5): "Italy", (0xE0, 0x6): "Belgium",
    (0xE0, 0x7): "Russian Federation", (0xE0, 0x8): "Palestine",
    (0xE0, 0x9): "Albania", (0xE0, 0xA): "Austria", (0xE0, 0xB): "Hungary",
    (0xE0, 0xC): "Malta", (0xE0, 0xD): "Germany", (0xE0, 0xF): "Egypt",
    (0xE1, 0x1): "Greece", (0xE1, 0x2): "Cyprus", (0xE1, 0x3): "San Marino",
    (0xE1, 0x4): "Switzerland", (0xE1, 0x5): "Jordan", (0xE1, 0x6): "Finland",
    (0xE1, 0x7): "Luxembourg", (0xE1, 0x8): "Bulgaria",
    (0xE1, 0x9): "Denmark", (0xE1, 0xA): "Gibraltar", (0xE1, 0xB): "Iraq",
    (0xE1, 0xC): "United Kingdom", (0xE1, 0xD): "Libya",
    (0xE1, 0xE): "Romania", (0xE1, 0xF): "France", (0xE2, 0x1): "Morocco",
    (0xE2, 0x2): "Czech Republic", (0xE2, 0x3): "Poland",
    (0xE2, 0x4): "Vatican", (0xE2, 0x5): "Slovakia", (0xE2, 0x6): "Syria",
    (0xE2, 0x7): "Tunisia", (0xE2, 0x9): "Liechtenstein",
    (0xE2, 0xA): "Iceland", (0xE2, 0xB): "Monaco", (0xE2, 0xC): "Lithuania",
    (0xE2, 0xD): "Serbia", (0xE2, 0xE): "Canary Islands",
    (0xE2, 0xF): "Norway", (0xE3, 0x1): "Montenegro", (0xE3, 0x2): "Ireland",
    (0xE3, 0x3): "Turkey", (0xE3, 0x5): "Tajikistan",
    (0xE3, 0x8): "Netherlands", (0xE3, 0x9): "Latvia", (0xE3, 0xA): "Lebanon",
    (0xE3, 0xB): "Azerbaijan", (0xE3, 0xC): "Croatia",
    (0xE3, 0xD): "Kazakhstan", (0xE3, 0xE): "Sweden", (0xE3, 0xF): "Belarus",
    (0xE4, 0x1): "Moldova", (0xE4, 0x2): "Estonia", (0xE4, 0x3): "Macedonia",
    (0xE4, 0x6): "Ukraine", (0xE4, 0x7): "Kosovo", (0xE4, 0x8): "Azores",
    (0xE4, 0x9): "Slovenia", (0xE4, 0xA): "Armenia",
    (0xE4, 0xB): "Uzbekistan", (0xE4, 0xC): "Georgia",
    (0xE4, 0xE): "Turkmenistan", (0xE4, 0xF): "Bosnia Herzegovina",
    (0xE5, 0x3): "Kyrgyzstan", (0xA1, 0xB): "Canada", (0xA1, 0xC): "Canada",
    (0xA1, 0xD): "Canada", (0xA1, 0xE): "Canada", (0xA1, 0xF): "Greenland",
    (0xA2, 0x1): "Anguilla", (0xA2, 0x2): "Antigua and Barbuda",
    (0xA2, 0x3): "Ecuador", (0xA2, 0x4): "Falkland Islands",
    (0xA2, 0x5): "Barbados", (0xA2, 0x6): "Belize",
    (0xA2, 0x7): "Cayman Islands", (0xA2, 0x8): "Costa Rica",
    (0xA2, 0x9): "Cuba", (0xA2, 0xA): "Argentina", (0xA2, 0xB): "Brazil",
    (0xA2, 0xC): "Bermuda", (0xA2, 0xD): "Netherlands Antilles",
    (0xA2, 0xE): "Guadeloupe", (0xA2, 0xF): "Bahamas", (0xA3, 0x1): "Bolivia",
    (0xA3, 0x2): "Colombia", (0xA3, 0x3): "Jamaica",
    (0xA3, 0x4): "Martinique", (0xA3, 0x6): "Paraguay",
    (0xA3, 0x7): "Nicaragua", (0xA3, 0x9): "Panama", (0xA3, 0xA): "Dominica",
    (0xA3, 0xB): "Dominican Republic", (0xA3, 0xC): "Chile",
    (0xA3, 0xD): "Grenada", (0xA3, 0xE): "Turks and Caicos islands",
    (0xA3, 0xF): "Guyana", (0xA4, 0x1): "Guatemala", (0xA4, 0x2): "Honduras",
    (0xA4, 0x3): "Aruba", (0xA4, 0x5): "Montserrat",
    (0xA4, 0x6): "Trinidad and Tobago", (0xA4, 0x7): "Peru",
    (0xA4, 0x8): "Surinam", (0xA4, 0x9): "Uruguay", (0xA4, 0xA): "St. Kitts",
    (0xA4, 0xB): "St. Lucia", (0xA4, 0xC): "El Salvador",
    (0xA4, 0xD): "Haiti", (0xA4, 0xE): "Venezuela", (0xA5, 0xB): "Mexico",
    (0xA5, 0xC): "St. Vincent", (0xA5, 0xD): "Mexico", (0xA5, 0xE): "Mexico",
    (0xA5, 0xF): "Mexico", (0xA6, 0x3): "Brazil", (0xA6, 0xC): "Brazil",
    (0xA6, 0xD): "Brazil", (0xA6, 0xF): "St. Pierre and Miquelon",
    (0xF0, 0x1): "Australia (City Commerical/Community)",
    (0xF0, 0x2): "Australia (Regional NSW/ACT)",
    (0xF0, 0x3): "Australia (City National)",
    (0xF0, 0x4): "Australia (Regional QLD)",
    (0xF0, 0x5): "Australia (Regional SA/NT)",
    (0xF0, 0x6): "Australia (Regional WA)",
    (0xF0, 0x7): "Australia (Regional VIC/TAS)",
    (0xF0, 0x8): "Australia (Regional Future)", (0xF0, 0x9): "Vanuatu",
    (0xF0, 0xA): "Yemen", (0xF0, 0xB): "Sri Lanka",
    (0xF0, 0xC): "Brunei Darussalam", (0xF0, 0xD): "Japan",
    (0xF0, 0xE): "Fiji", (0xF0, 0xF): "Iran", (0xF1, 0x1): "Korea (South)",
    (0xF1, 0x2): "Cambodia", (0xF1, 0x3): "Hong Kong",
    (0xF1, 0x4): "Solomon Islands", (0xF1, 0x5): "Bahrain",
    (0xF1, 0x6): "Western Samoa", (0xF1, 0x7): "Taiwan",
    (0xF1, 0x8): "Malaysia", (0xF1, 0x9): "Singapore",
    (0xF1, 0xA): "Pakistan", (0xF1, 0xB): "China",
    (0xF1, 0xC): "Myanmar (Burma)", (0xF1, 0xD): "Nauru",
    (0xF1, 0xE): "Kiribati", (0xF1, 0xF): "Bangladesh",
    (0xF2, 0x1): "Vietnam", (0xF2, 0x2): "Philippines", (0xF2, 0x3): "Bhutan",
    (0xF2, 0x4): "Oman", (0xF2, 0x5): "Nepal",
    (0xF2, 0x6): "United Arab Emirates", (0xF2, 0x7): "Kuwait",
    (0xF2, 0x8): "Qatar", (0xF2, 0x9): "Korea (North)",
    (0xF2, 0xA): "New Zealand", (0xF2, 0xB): "Tonga",
    (0xF2, 0xC): "Micronesia", (0xF2, 0xD): "Macau", (0xF2, 0xE): "India",
    (0xF2, 0xF): "Saudi Arabia", (0xF3, 0x1): "Iraq", (0xF3, 0x2): "Mongolia",
    (0xF3, 0x3): "Maldives", (0xF3, 0x9): "Papua New Guinea",
    (0xF3, 0xB): "Afghanistan", (0xF3, 0xE): "Indonesia",
    (0xF3, 0xF): "Thailand",
}


def country_label(ecc: int, country_id: int) -> str:
    return COUNTRIES.get((ecc, country_id), f"ECC {ecc:02X}/{country_id:X}")
