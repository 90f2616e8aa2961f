"""injectbin — flow-synchronized hot element swap.

Rebuild of plugins/injectbin/gstinjectbin.c: a bin with a permanent internal
``identity`` anchor (the probe attachment point, rationale :295-305).
Setting the ``element`` property from ANY thread installs a blocking probe
on the anchor's sink pad (:193-223, replacing a pending probe :209-213);
the probe fires on the streaming thread between buffers, tears the old
element down (locked-state → NULL → unlink → remove :136-147), links the
new one, retargets the src ghost pad, syncs state (:149-173), and emits
``notify::element`` (:176-191). A None element means passthrough through
the anchor.

Device work: before any dataflow block is installed, the incoming
element is PRE-WARMED against the currently negotiated caps
(``Element.prewarm``: a CUDA encoder builds its kernels and encodes one
batch) — the stream keeps flowing through the old element meanwhile, so
the observable swap gap stays bounded by queue depth (the reference's
brief-block contract) rather than paying a first-buffer kernel build on
the streaming thread. The swap machinery itself stays host-side and
data-flow synchronized, so in-flight device work of the old stage drains
before teardown.

A copy of flutpu/inject/injectbin.py on the port's core.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..core import (Bin, Element, ProbeReturn, ProbeType, PropertySpec,
                    State, register)
from ..core.elements import Identity
from ..core.log import category

CAT = category("injectbin")


@register
class InjectBin(Bin):
    """Hot element swap from any thread, synchronized with dataflow
    (reference: injectbin)."""

    FACTORY = "injectbin"
    PROPERTIES = [
        PropertySpec("element", None, "element to inject (None = passthrough)",
                     ptype=object),
    ]

    def __init__(self, name: Optional[str] = None, **props):
        # anchor first so property side effects find it
        self._identity = Identity(name="inject-identity")
        self._current: Optional[Element] = None
        self._requested: Optional[Element] = None
        self._pending_probe: Optional[int] = None
        self._swap_lock = threading.Lock()
        self._in_swap = False
        super().__init__(name)
        self.add(self._identity)
        self.sinkpad = self.add_ghost_pad("sink", self._identity.sinkpad)
        self.srcpad = self.add_ghost_pad("src", self._identity.srcpad)
        for k, v in props.items():
            self.set_property(k.replace("_", "-"), v)

    # -- property ----------------------------------------------------------
    def do_set_property(self, name: str, value) -> None:
        if name != "element":
            return
        # Pre-warm the incoming element's device programs against the
        # current negotiated caps BEFORE any dataflow block exists
        # (SURVEY §7.7: drain → retarget only after the new program is
        # ready). The stream keeps flowing through the old element while
        # the compile runs, so the swap gap stays bounded by queue depth
        # — the reference's brief-block contract (gstinjectbin.c:131-174)
        # — instead of a minutes-long first-compile stall on the
        # streaming thread.
        if value is not None and self.state >= State.PAUSED:
            from ..core.events import EventType
            caps_ev = self._identity.sinkpad.sticky.get(EventType.CAPS)
            try:
                if value.prewarm(caps_ev.caps if caps_ev else None):
                    CAT.info("pre-warmed %s for swap", value.name)
            except Exception as e:  # warm failure must not block the swap
                CAT.warning("prewarm of %s failed: %s", value.name, e)
        with self._swap_lock:
            self._requested = value
            if self._pending_probe is not None:
                # a queued swap not yet executed: replace it
                self._identity.sinkpad.remove_probe(self._pending_probe)
                self._pending_probe = None
            if self.state < State.PAUSED:
                # no dataflow possible: swap immediately
                self._update_element_locked()
                return
            self._pending_probe = self._identity.sinkpad.add_probe(
                ProbeType.BLOCK_DOWNSTREAM, self._swap_probe)

    def do_get_property(self, name: str):
        if name == "element":
            return self._current
        return None

    def notify(self, prop: str) -> None:
        # notify::element signals a COMPLETED swap (reference :188), not a
        # queued request — suppress the generic property notification
        if prop == "element" and not self._in_swap:
            return
        super().notify(prop)

    # -- swap --------------------------------------------------------------
    def _swap_probe(self, pad, data) -> ProbeReturn:
        with self._swap_lock:
            self._pending_probe = None
            self._update_element_locked()
        return ProbeReturn.REMOVE

    def _update_element_locked(self) -> None:
        new = self._requested
        old = self._current
        if new is old:
            return
        CAT.info("swapping %s -> %s",
                 old.name if old else "passthrough",
                 new.name if new else "passthrough")
        if old is not None:
            old.locked_state = True
            old.set_state(State.NULL)
            self._identity.srcpad.unlink()
            if old.static_src_pad is not None:
                old.static_src_pad.unlink()
            self.remove(old)
            old.locked_state = False
        if new is not None:
            new.name = f"{self.name}-injected"
            self.add(new)
            self.srcpad.set_target(new.static_src_pad)
            self._identity.srcpad.link(new.static_sink_pad)
            # replay negotiation state into the new element so it sees
            # current caps/segment before the pending datum
            for ev in sorted(self._identity.sinkpad.sticky.values(),
                             key=lambda e: e.seqnum):
                new.static_sink_pad.send_event(ev)
            new.sync_state_with_parent()
            self._current = new
        else:
            self.srcpad.set_target(self._identity.srcpad)
            self._current = None
        self._props["element"] = self._current
        self._in_swap = True
        try:
            self.notify("element")
        finally:
            self._in_swap = False
