# Copied from beats3d_tpu/runtime/midi.py (numpy / host only).
"""MIDI output (reference src/engine/midi.py:4-34).

Uses python-rtmidi when present (picking a LoopBe virtual loopback port if one
exists, else port 0, like the reference midi.py:10-17).  Headless/TPU-host
environments rarely have a MIDI stack, so the default fallback is an event
sink that records (and optionally logs) every message with a timestamp — this
is also what the note-event parity tests consume.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple


class MidiSink:
    """Records MIDI messages; the headless stand-in for a real port."""

    def __init__(self, log=None):
        self.events: List[Tuple[float, Tuple[int, ...]]] = []
        self._log = log

    def send(self, msg):
        self.events.append((time.perf_counter(), tuple(msg)))
        if self._log:
            self._log(f"midi: {[hex(m) for m in msg]}")

    def note_events(self):
        """[(t, 'on'|'off', note, velocity)] for tests/analysis."""
        out = []
        for t, msg in self.events:
            kind = msg[0] & 0xF0
            if kind == 0x90:
                out.append((t, "on", msg[1], msg[2]))
            elif kind == 0x80:
                out.append((t, "off", msg[1], msg[2]))
        return out


class Midi:
    """Real MIDI out via rtmidi, with automatic sink fallback."""

    def __init__(self, port_name_hint: str = "LoopBe", log=None):
        self.sink = MidiSink(log)
        self.out = None
        self.port_names: List[str] = []
        self.port = -1
        try:
            import rtmidi  # type: ignore

            self.out = rtmidi.MidiOut()
            self.port_names = self.out.get_ports()
            if self.port_names:
                self.port = 0
                for i, p in enumerate(self.port_names):
                    if port_name_hint.lower() in p.lower():
                        self.port = i
                        break
                self.out.open_port(self.port)
        except Exception:
            self.out = None

    def set_port(self, port: int):
        if self.out is not None and 0 <= port < len(self.port_names):
            self.out.close_port()
            self.out.open_port(port)
            self.port = port

    def send(self, msg):
        self.sink.send(msg)
        if self.out is not None:
            self.out.send_message(list(msg))
