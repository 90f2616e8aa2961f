"""TTMLBase — the abstract streaming TTML element.

Rebuild of plugins/ttml/gstttmlbase.c: the sink chain feeds a streaming
push parser (expat here, libxml2 SAX there); handlers drive the state
machine and build the event timeline; concatenated XML documents inside one
buffer are split on ``tt>`` terminators; ``gen_buffer`` (subclass hook)
renders each interval between timeline events, clipped to the segment; time
seeks translate to a byte-0 upstream seek plus self-clipping.

Subclass contract (GstTTMLBaseClass vfuncs, gstttmlbase.h:71-98):
``gen_buffer(begin, end)`` composes output from the active spans/regions;
``complete_caps``/``fixate_caps``/``src_caps`` negotiate the output format;
``reset_hook`` clears derived state.
"""

from __future__ import annotations

import base64 as _b64
import re
from typing import Dict, List, Optional
from xml.parsers import expat

from ..core import (Buffer, Caps, CapsEvent, Element, Event, EventType,
                    FlowReturn, Pad, PadDirection, PropertySpec, SeekEvent,
                    Segment, SegmentEvent)
from ..core.log import category
from .attributes import Attribute, parse_attribute
from .enums import AttrType, NodeType, NODE_BY_NAME
from .namespace import Namespace, NamespaceStore, namespace_is_ttml
from .span import Span, SpanList
from .state import TTMLState
from .style import Style
from .timeline import (Timeline, TimelineEvent, TimelineEventType,
                       region_attr_update, region_begin, region_end,
                       span_attr_update, span_begin, span_end)

_INF = 1 << 62  # CLOCK_TIME_NONE stop stand-in for flush bounds

CAT = category("ttmlbase")


class _CharBuffer:
    """Whitespace-collapsing character accumulator
    (gstttmlbase.c:733-779)."""

    def __init__(self):
        self.chars: List[str] = []
        self.enable = False
        self.preserve_whitespace = False
        self.insert_space = True
        self.line_has_chars = False
        self.collapsing = False
        self.space_done = False  # deferred space already materialized

    def reset(self, enable: bool, preserve: bool, insert_space: bool = True):
        self.chars = []
        self.enable = enable
        self.preserve_whitespace = preserve
        self.insert_space = insert_space
        self.line_has_chars = False
        self.collapsing = False
        self.space_done = False

    def add(self, text: str) -> None:
        if not self.enable:
            return
        if self.preserve_whitespace:
            self.chars.append(text)
            if text:
                self.line_has_chars = True
                self.collapsing = False
                self.space_done = False
            return
        out = []
        for c in text:
            if c in " \t\r\n":
                self.collapsing = True
            else:
                if self.collapsing and self.line_has_chars \
                        and self.insert_space and not self.space_done:
                    out.append(" ")
                out.append(c)
                self.collapsing = False
                self.line_has_chars = True
                self.space_done = False
        self.chars.append("".join(out))

    def flush_pending_space(self) -> None:
        """Materialize a deferred collapse space at an inline flush
        boundary (span start/end): "me <span>x" must keep its word
        boundary even though the space precedes the flush. space_done
        suppresses the duplicate when the next scope re-derives it."""
        if (self.enable and not self.preserve_whitespace and self.collapsing
                and self.line_has_chars and self.insert_space
                and not self.space_done):
            self.chars.append(" ")
            self.space_done = True

    def take(self) -> str:
        s = "".join(self.chars)
        self.chars = []
        return s

    @property
    def has_data(self) -> bool:
        return any(self.chars)


class TTMLBase(Element):
    """Abstract base; derived elements implement the output format."""

    SINK_CAPS = "application/ttml+xml"

    PROPERTIES = [
        PropertySpec("assume-ordered-spans", False,
                     "flush output as soon as a later span begins "
                     "(latency/compat tradeoff, gstttmlbase.c:306-312)"),
    ]

    def __init__(self, name: Optional[str] = None, **props):
        super().__init__(name, **props)
        self.sinkpad = self.add_pad(Pad(
            "sink", PadDirection.SINK, self,
            template_caps=Caps.from_string(self.SINK_CAPS)))
        self.srcpad = self.add_pad(Pad("src", PadDirection.SRC, self))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._sink_event
        self.srcpad.event_function = self._src_event

        self.parse_state = TTMLState()
        self.timeline = Timeline()
        self.active_spans = SpanList()
        self.active_regions: Dict[str, Style] = {}
        self.namespaces = NamespaceStore()
        self.is_std_ebu = False
        self._buf = _CharBuffer()
        self._parser: Optional[expat.XMLParserType] = None
        self._in_styling = False
        self._in_layout = False
        self._in_metadata = False
        self.segment: Optional[Segment] = None
        self.pending_segment: Optional[Segment] = None
        self._newsegment_needed = True
        self.last_out_time = 0
        self.base_time: Optional[int] = None
        self.input_buf_start = 0
        self.input_buf_stop: Optional[int] = None
        self.current_status = FlowReturn.OK
        self._out_caps: Optional[Caps] = None

    # ------------------------------------------------------------------
    # subclass hooks
    # ------------------------------------------------------------------
    def gen_buffer(self, begin: int, end: int) -> Optional[Buffer]:
        raise NotImplementedError

    def src_caps(self) -> Caps:
        """Output caps for negotiation; subclasses refine."""
        return Caps.any()

    def reset_hook(self) -> None:
        """Derived-class state reset on flush/new document."""

    # ------------------------------------------------------------------
    # parse driving
    # ------------------------------------------------------------------
    def _new_parser(self) -> expat.XMLParserType:
        p = expat.ParserCreate(namespace_separator=" ")
        p.StartElementHandler = self._sax_start
        p.EndElementHandler = self._sax_end
        p.CharacterDataHandler = self._sax_chars
        p.StartNamespaceDeclHandler = self._sax_ns
        p.buffer_text = True
        return p

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self.current_status = FlowReturn.OK
        data = buf.data
        if isinstance(data, str):
            data = data.encode("utf-8")
        data = bytes(data)
        if buf.pts is not None:
            self.input_buf_start = buf.pts
            self.input_buf_stop = (buf.pts + buf.duration
                                   if buf.duration is not None else None)
        else:
            self.input_buf_start = 0
            self.input_buf_stop = None
        if self.base_time is None:
            self.base_time = self.input_buf_start

        while data:
            # a fresh document opener while a parser is still open means the
            # previous document ended without a </tt> → finish it first
            if self._parser is not None and (
                    data.startswith(b"<tt") or data.startswith(b"<?xml")):
                self._finish_document()

            # split concatenated documents on the first CLOSING tt tag —
            # </tt>, </ns:tt>, with optional whitespace before '>'
            # (gstttmlbase.c:1059-1144 contract). A substring search for
            # "tt>" is wrong for a bare <tt> root: its OPENING tag
            # contains "tt>" at an index whose predecessor fails the
            # '/'/':' check, and the first-match-only logic then never
            # split the buffer at the real </tt> (the second concatenated
            # document was fed to the same expat parser and silently
            # dropped as junk-after-document-element)
            doc_ended = False
            rest = b""
            m = re.search(rb"</(?:[\w.-]+:)?tt\s*>", data)
            if m:
                end = m.end()
                rest = data[end:]
                data = data[:end]
                doc_ended = True

            if self._parser is None:
                self._parser = self._new_parser()
                self._doc_start()
            try:
                self._parser.Parse(data, False)
            except expat.ExpatError:
                pass  # SAX errors become logs in the reference
            except LookupError as e:
                # an unknown declared encoding (<?xml encoding="u-8"?>)
                # surfaces from pyexpat as LookupError, not ExpatError —
                # libxml2 reports it as a SAX-level error; match that
                # (fuzz-found on a mutated XML declaration)
                CAT.warning("unsupported XML encoding: %s", e)

            if doc_ended:
                self._finish_document()
                rest = rest.lstrip()
            data = rest
        return self.current_status

    def _finish_document(self) -> None:
        if self._parser is not None:
            try:
                self._parser.Parse(b"", True)
            except (expat.ExpatError, LookupError):
                pass
            self._parser = None
        self._doc_end()
        self._reset_parse(keep_segment=True)
        self.base_time = None

    def _doc_start(self) -> None:
        self._in_styling = False
        self._in_layout = False
        self._in_metadata = False
        self._anon_region_seq = 0
        self.parse_state.reset()
        frame_w, frame_h = self.frame_dimensions()
        self.parse_state.frame_width = frame_w
        self.parse_state.frame_height = frame_h

    def frame_dimensions(self):
        """(width, height) for length normalization; renderers override."""
        return 0, 0

    def _doc_end(self) -> None:
        CAT.debug("document complete: %d timeline events pending",
                  len(self.timeline))
        self._flush_timeline()

    def _flush_timeline(self) -> None:
        bounded = self.input_buf_stop is not None
        stop = self.input_buf_stop if bounded else _INF
        self.last_out_time = self.timeline.flush(
            stop, self.last_out_time, self._apply_event, self._emit_interval,
            emit_tail=bounded)

    # ------------------------------------------------------------------
    # timeline application (gstttmlbase.c:202-247)
    # ------------------------------------------------------------------
    def _apply_event(self, event: TimelineEvent) -> None:
        t = event.type
        if t == TimelineEventType.SPAN_BEGIN:
            self.active_spans.add(event.span)
        elif t == TimelineEventType.SPAN_END:
            self.active_spans.remove(event.span_id)
        elif t == TimelineEventType.SPAN_ATTR_UPDATE:
            self.active_spans.update_attr(event.span_id, event.attr)
        elif t == TimelineEventType.REGION_BEGIN:
            self.active_regions[event.region_id] = event.style
        elif t == TimelineEventType.REGION_END:
            self.active_regions.pop(event.region_id, None)
        elif t == TimelineEventType.REGION_ATTR_UPDATE:
            style = self.active_regions.get(event.region_id)
            if style is not None:
                style.set(event.attr)

    def _emit_interval(self, begin: int, end: int) -> None:
        """Clip to segment and push one composed buffer
        (gstttmlbase.c:94-198)."""
        if begin < self.last_out_time:
            begin = self.last_out_time
        if self.current_status != FlowReturn.OK:
            return
        self._negotiate()
        if self.segment is None:
            start = begin if len(self.active_spans) == 0 else (self.base_time or 0)
            self.segment = Segment(start=start)
        unbounded = end >= _INF
        if unbounded:
            end = begin  # zero-length render window; duration reported unknown
        clipped = self.segment.clip(begin, end - begin)
        if clipped is None:
            return
        cbegin, cdur = clipped
        if self._deliver_interval(cbegin, cdur, unbounded):
            self.last_out_time = cbegin + (cdur or 0)

    def _deliver_interval(self, cbegin: int, cdur: Optional[int],
                          unbounded: bool) -> bool:
        """Render + push one interval buffer; returns whether one was
        produced. Subclass hook: renderers may defer the push to batch
        device work across the whole flush (render/render_el.py)."""
        buf = self.gen_buffer(cbegin, cbegin + (cdur or 0))
        if buf is None:
            return False
        self._push_interval_buffer(buf, cbegin, cdur, unbounded)
        return True

    def _push_interval_buffer(self, buf: Buffer, cbegin: int,
                              cdur: Optional[int], unbounded: bool) -> None:
        if self._newsegment_needed:
            self.srcpad.push_event(SegmentEvent(self.segment.copy()))
            self._newsegment_needed = False
        buf.pts = cbegin
        buf.duration = None if unbounded else cdur
        self.current_status = self.srcpad.push(buf)

    def _negotiate(self) -> None:
        if self._out_caps is None:
            caps = self.src_caps()
            self._out_caps = caps
            self.srcpad.push_event(CapsEvent(caps))

    # ------------------------------------------------------------------
    # SAX handlers
    # ------------------------------------------------------------------
    @staticmethod
    def _split_name(name: str):
        if " " in name:
            uri, local = name.rsplit(" ", 1)
            return uri, local
        return None, name

    def _sax_ns(self, prefix, uri):
        self.namespaces.add(prefix, uri or "")
        if uri and "ebu:tt" in uri:
            self.is_std_ebu = True
            self.parse_state.cell_resolution_x = 40
            self.parse_state.cell_resolution_y = 24

    def _sax_start(self, name: str, attrs: Dict[str, str]) -> None:
        uri, local = self._split_name(name)
        node_type = NODE_BY_NAME.get(local, NodeType.UNKNOWN) \
            if namespace_is_ttml(uri) else NodeType.UNKNOWN
        state = self.parse_state
        is_container_seq = state.sequential_time_container
        dur_found = False

        if node_type == NodeType.P:
            self._buf.reset(True, state.whitespace_preserve)
        elif node_type == NodeType.SPAN:
            self._add_span(newline=False)
            # the span continues the SAME text line: carry the pending
            # collapse state across the reset or "me <span>x" loses its
            # word boundary and renders "mex" (round-4 corpus
            # Whitespace001)
            keep_line = self._buf.line_has_chars
            keep_coll = self._buf.collapsing
            keep_done = self._buf.space_done
            self._buf.reset(True, state.whitespace_preserve)
            self._buf.line_has_chars = keep_line
            self._buf.collapsing = keep_coll
            self._buf.space_done = keep_done
        elif node_type == NodeType.SMPTE_IMAGE:
            self._buf.reset(True, False, insert_space=False)
        elif node_type == NodeType.TT:
            if not self.is_std_ebu:
                state.cell_resolution_x = 32
                state.cell_resolution_y = 15
        elif node_type == NodeType.STYLING:
            self._in_styling = True
        elif node_type == NodeType.LAYOUT:
            self._in_layout = True
        elif node_type == NodeType.METADATA:
            self._in_metadata = True

        # nested style-in-region: the style node's attributes apply directly
        # to the parent region — no node delimiter (gstttmlbase.c:552-573)
        if node_type != NodeType.STYLE or not self._in_layout:
            state.push_attribute(Attribute(AttrType.NODE_TYPE, node_type))
            state.push_attribute(Attribute(AttrType.TIME_CONTAINER, False))
            if is_container_seq:
                state.push_attribute(Attribute(AttrType.BEGIN, 0))

        # style references first so node-local attrs override them
        def push(k: str, v: str) -> bool:
            kuri, klocal = self._split_name(k)
            try:
                attr = parse_attribute(state, kuri, klocal, v)
            except (ValueError, ZeroDivisionError, IndexError):
                # a malformed numeric value ("29.97i", "50%", "30 0") is an
                # ignorable attribute, not a stream error — the reference
                # logs SAX-level junk and keeps parsing
                # (gstttmlbase.c:783-807); matches parse_time_expression's
                # None-on-garbage convention
                CAT.warning("ignoring malformed attribute %s=%r", k, v)
                return False
            if attr is not None:
                state.push_attribute(attr)
                return attr.type == AttrType.DUR
            return False

        for k, v in attrs.items():
            if self._split_name(k)[1] == "style":
                push(k, v)
        for k, v in attrs.items():
            if self._split_name(k)[1] != "style":
                if push(k, v):
                    dur_found = True

        if is_container_seq and not dur_found:
            state.push_attribute(Attribute(AttrType.DUR, 0))

        state.container_begin = state.begin
        state.container_end = state.end

        # the char-buffer resets above ran BEFORE this element's xml:space
        # was parsed — sync the preserve mode to the new scope now
        if node_type in (NodeType.P, NodeType.SPAN):
            self._buf.preserve_whitespace = state.whitespace_preserve

        if node_type == NodeType.BR:
            self._add_span(newline=True)

    def _sax_end(self, name: str) -> None:
        uri, local = self._split_name(name)
        node_type = NODE_BY_NAME.get(local, NodeType.UNKNOWN) \
            if namespace_is_ttml(uri) else NodeType.UNKNOWN
        state = self.parse_state
        current_begin = state.begin
        current_end = state.end

        if node_type == NodeType.STYLE and self._in_layout:
            return  # attrs stay merged into the region (see _sax_start)

        if node_type == NodeType.P:
            self._add_span(newline=True)
            self._buf.enable = False
        elif node_type == NodeType.SPAN:
            self._add_span(newline=False)
        elif node_type == NodeType.SMPTE_IMAGE:
            self._decode_data()
            self._buf.enable = False
        elif node_type == NodeType.STYLING:
            self._in_styling = False
        elif node_type == NodeType.STYLE:
            if self._in_styling and state.id:
                state.save_attr_stack(state.saved_styling, state.id)
        elif node_type == NodeType.LAYOUT:
            self._in_layout = False
        elif node_type == NodeType.REGION:
            if self._in_layout:
                self._add_region()
        elif node_type == NodeType.METADATA:
            self._in_metadata = False

        # pop everything this element pushed; SET nodes convert popped
        # styling attributes into animation timeline entries on the parent
        # style (gstttmlbase.c:688-711)
        from .enums import is_styling as _is_styling
        while True:
            restored_type, replaced = state.pop_attribute()
            if restored_type is None:
                break
            if node_type == NodeType.SET and replaced is not None \
                    and _is_styling(restored_type) \
                    and (current_end is None
                         or current_end > (current_begin or 0)):
                # an EMPTY active window (begin == end, e.g. a
                # zero-duration SET) must have no effect: the end event
                # is written at end-1, which would sort BEFORE the begin
                # event and leave the SET value applied to the cue's end
                # (round-5 corpus Animation027 caught exactly this —
                # red from 1s onward plus a 1 ns sliver interval)
                # raw dict access: a value-None placeholder (animated
                # attribute with no base value) must be REUSED so repeated
                # SETs share one timeline — Style.get hides placeholders
                target = state.style.attributes.get(restored_type)
                if target is None:
                    target = Attribute(restored_type, None)
                    state.style.set(target)
                target.add_event(current_begin or 0, replaced)
                end_ts = (current_end - 1) if current_end is not None else _INF
                target.add_event(end_ts, target)
            if restored_type == AttrType.NODE_TYPE:
                break

        # restore the container window for following siblings
        if state.sequential_time_container:
            state.container_begin = current_end
        else:
            state.container_begin = state.begin
        state.container_end = state.end

        # the attribute pop restored the OUTER scope's xml:space — tail
        # text after </span> must collapse by the outer scope, not the
        # span's (round-4 corpus Whitespace001: a preserve span leaked
        # preservation into the following text)
        if node_type in (NodeType.P, NodeType.SPAN) and self._buf.enable:
            self._buf.preserve_whitespace = state.whitespace_preserve

    def _sax_chars(self, text: str) -> None:
        self._buf.add(text)

    # ------------------------------------------------------------------
    # span / region / data creation
    # ------------------------------------------------------------------
    def _add_span(self, newline: bool) -> None:
        """gstttmlbase.c:255-337."""
        state = self.parse_state
        buf = self._buf
        if newline and buf.enable:
            buf.preserve_whitespace = True
            buf.add("\n")
            buf.line_has_chars = False
        else:
            # inline flush (span boundary): trailing deferred space stays
            buf.flush_pending_space()
        chars = buf.take()
        buf.preserve_whitespace = state.whitespace_preserve
        if not chars:
            return
        if state.begin is None and state.end is None:
            return  # no timing info
        if state.node_type == NodeType.P and state.sequential_time_container:
            return  # anonymous spans in seq containers have 0 duration
        if state.begin is not None and state.end is not None \
                and state.begin >= state.end:
            return  # zero duration
        if self.get_property("assume-ordered-spans") and \
                state.begin is not None and state.begin > self.last_out_time:
            self._flush_timeline()
        span_id = state.last_span_id
        state.last_span_id += 1
        span = Span(span_id, chars, state.style.copy(True),
                    region_id=(state.style.get(AttrType.REGION).value
                               if state.style.get(AttrType.REGION) else None))
        self.timeline.insert(span_begin(state, span))
        self.timeline.insert(span_end(state, span_id))
        for ts, attr in state.style.collect_events():
            self.timeline.insert(span_attr_update(span_id, ts, attr))

    def _add_region(self) -> None:
        """gstttmlbase.c:341-381."""
        state = self.parse_state
        if state.begin is not None and state.end is not None \
                and state.begin >= state.end:
            return
        pushed_zindex = False
        if state.style.get(AttrType.ZINDEX) is None:
            # auto zIndex with lexical tiebreak micro index
            state.push_attribute(Attribute(AttrType.ZINDEX,
                                           state.next_zindex_micro()))
            pushed_zindex = True
        begin = state.begin if state.begin is not None else 0
        end = state.end if state.end is not None else _INF
        # anonymous regions need DISTINCT ids per document: active_regions
        # is the runtime dict (empty at parse time), so counting it gave
        # every anonymous region "region-0" and the second's REGION_BEGIN
        # clobbered the first's style at flush
        rid = state.id
        if not rid:
            rid = f"region-anon{getattr(self, '_anon_region_seq', 0)}"
            self._anon_region_seq = getattr(self, "_anon_region_seq", 0) + 1
        self.timeline.insert(region_begin(begin, rid, state.style.copy(True)))
        self.timeline.insert(region_end(end, rid))
        for ts, attr in state.style.collect_events():
            self.timeline.insert(region_attr_update(ts, rid, attr))
        if pushed_zindex:
            state.pop_attribute()

    def _decode_data(self) -> None:
        """gstttmlbase.c:387-436: base64 image payload → saved_data."""
        state = self.parse_state
        raw = self._buf.take()
        if not raw:
            return
        enc_attr = state.style.get(AttrType.SMPTE_ENCODING)
        from .enums import SmpteEncoding, SmpteImageType
        if enc_attr is not None and enc_attr.value != SmpteEncoding.BASE64:
            return
        img_attr = state.style.get(AttrType.SMPTE_IMAGE_TYPE)
        if img_attr is not None and img_attr.value != SmpteImageType.PNG:
            return
        if not state.id:
            return
        try:
            data = _b64.b64decode("".join(raw.split()))
        except Exception:
            return
        state.save_data(data, state.id)

    # ------------------------------------------------------------------
    # events / reset / seek
    # ------------------------------------------------------------------
    def _reset_parse(self, keep_segment: bool = False) -> None:
        self.timeline.clear()
        self.active_spans.clear()
        self.active_regions.clear()
        self.namespaces.clear()
        self.is_std_ebu = False
        self._buf.reset(False, False)
        self.reset_hook()

    def _cleanup(self) -> None:
        """Flush teardown (gstttmlbase.c cleanup): adopt pending segment."""
        if self.pending_segment is not None:
            self.segment = self.pending_segment
            self.pending_segment = None
        else:
            self.segment = None
        self._newsegment_needed = True
        self.current_status = FlowReturn.OK
        self.input_buf_start = 0
        self.last_out_time = self.segment.start if self.segment else 0
        if self._parser is not None:
            self._parser = None
        self.parse_state.reset()
        self._reset_parse()

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.CAPS:
            return True  # dropped; src caps are ours to decide
        if event.type == EventType.SEGMENT:
            seg = event.segment
            if seg.format != "time":
                return True
            self.segment = seg.copy()
            self.last_out_time = seg.start
            return True
        if event.type == EventType.FLUSH_STOP:
            self._cleanup()
            return self.srcpad.push_event(event)
        if event.type == EventType.EOS:
            if self._parser is not None:
                self._finish_document()
            else:
                self._flush_timeline()
            return self.srcpad.push_event(event)
        return self.srcpad.push_event(event)

    def get_upstream_uri(self) -> Optional[str]:
        """Walk upstream for a source with a ``location`` property so
        relative resource URLs (SMPTE background images) can resolve
        (reference gstttmlbase.c:1160-1228)."""
        el = self
        seen = set()
        while el is not None and id(el) not in seen:
            seen.add(id(el))
            try:
                loc = el.get_property("location")
                if loc:
                    return f"file://{loc}" if "://" not in str(loc) else str(loc)
            except KeyError:
                pass
            nxt = None
            for pad in el.sink_pads():
                peer = pad.peer
                if peer is not None and peer.element is not None:
                    nxt = peer.element
                    break
                if pad._proxy_target is not None:
                    tgt = pad._proxy_target
                    if tgt.element is not None:
                        nxt = tgt.element
                        break
            el = nxt
        return None

    def _src_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.SEEK:
            if event.structure.get("format", "time") != "time":
                return False
            # remember the requested window for self-clipping, then restart
            # upstream from byte 0 (gstttmlbase.c:1347-1373)
            self.pending_segment = Segment(start=event.start, stop=event.stop,
                                           time=event.start)
            byte_seek = SeekEvent(0, None, format="bytes",
                                  flush=event.flush)
            ok = self.sinkpad.push_event(byte_seek)
            if ok and not event.flush:
                # no FLUSH_STOP will arrive to adopt the pending window
                # (cleanup only runs on flush) — adopt it now; the
                # upstream restart re-parses from byte 0 either way
                self._cleanup()
            return ok
        return self.sinkpad.push_event(event)
