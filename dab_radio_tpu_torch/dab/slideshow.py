"""MOT slideshow (ETSI TS 101 499) entity interpretation and management.

Parity surface: reference src/dab/mot/MOT_slideshow_processor.{h,cpp} and
src/basic_radio/basic_slideshow.{h,cpp}: slideshow-specific MOT user-app
header extensions (category/slide id, titles, URLs, alerts) and a bounded
most-recent-first slideshow store with change notifications.
"""

from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

from .charsets import decode_label
from .mot import MOTEntity

# MOT content type/subtype (TS 101 756 table 17): image = 2
CONTENT_IMAGE = 2
SUBTYPE_JPEG, SUBTYPE_PNG = 1, 3

ALERT_NOT_USED, ALERT_EMERGENCY, ALERT_RESERVED = 0, 1, 2


@dataclass
class Slideshow:
    transport_id: int
    image_type: str                 # 'jpeg' | 'png'
    name: str = ""
    data: bytes = b""
    category_id: int = 0
    slide_id: int = 0
    category_title: str = ""
    click_through_url: str = ""
    alt_location_url: str = ""
    alert: int = ALERT_NOT_USED
    expire_time: Optional[object] = None
    trigger_time: Optional[object] = None


def parse_slideshow_params(slideshow: Slideshow, params):
    """Apply MOT user-app header extension params (TS 101 499 clause 6.2)."""
    for pid, buf in params:
        if pid == 0x25 and len(buf) == 2:
            slideshow.category_id, slideshow.slide_id = buf[0], buf[1]
        elif pid == 0x26:
            slideshow.category_title = decode_label(buf, 15)
        elif pid == 0x27:
            slideshow.click_through_url = decode_label(buf, 15)
        elif pid == 0x28:
            slideshow.alt_location_url = decode_label(buf, 15)
        elif pid == 0x29 and len(buf) == 1:
            slideshow.alert = buf[0] if buf[0] <= 1 else ALERT_RESERVED


class SlideshowManager:
    def __init__(self, max_slideshows: int = 25):
        self.slideshows = deque(maxlen=max_slideshows)
        self.on_slideshow: List[Callable[[Slideshow], None]] = []

    # external observers don't checkpoint (re-attach after restore)
    def __getstate__(self):
        d = dict(self.__dict__)
        d["on_slideshow"] = []
        return d

    def process_mot_entity(self, entity: MOTEntity) -> Optional[Slideshow]:
        if entity.header.content_type != CONTENT_IMAGE:
            return None
        sub = entity.header.content_sub_type
        if sub == SUBTYPE_JPEG:
            image_type = "jpeg"
        elif sub == SUBTYPE_PNG:
            image_type = "png"
        else:
            return None
        s = Slideshow(transport_id=entity.transport_id, image_type=image_type,
                      name=entity.header.content_name or "",
                      data=entity.body,
                      expire_time=entity.header.expire_time,
                      trigger_time=entity.header.trigger_time)
        parse_slideshow_params(s, entity.header.user_app_params)
        self.slideshows.appendleft(s)
        for cb in self.on_slideshow:
            cb(s)
        return s
