"""One fake card for the CPU tests of the kernel wrappers in ops/.

``on_fake_card`` stands a card in through ops/runtime.py alone, the one
place every wrapper loads a library and launches from: each library it
asks for is ``lib`` (a stand-in that records its calls), on a card of
``SMS`` SMs, with no stream (each launch passes None) and no device
switch, and ``check_map`` in place of the feature-map check (none by
default). The occupancy query runs uncached, so each test asks its own
stand-in.
"""

import contextlib

from cl_ica_tpu_torch.ops import runtime

SMS = 132


def on_fake_card(monkeypatch, lib, check_map=None) -> None:
    monkeypatch.setattr(runtime, "library", lambda name, declare: lib)
    monkeypatch.setattr(runtime, "sm_count", lambda device_index: SMS)
    monkeypatch.setattr(runtime, "resident_blocks", runtime.resident_blocks.__wrapped__)
    monkeypatch.setattr(runtime, "stream", lambda device: None)
    monkeypatch.setattr(runtime, "device_guard", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(runtime, "check_map", check_map or (lambda *args, **kw: None))
