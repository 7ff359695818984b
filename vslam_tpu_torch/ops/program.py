"""A function of tensors as one device program over static buffers: the
port's counterpart of a JAX function jitted at one shape.

`StaticProgram(fn, buffers, events)` holds the inputs of `fn` as static
buffers (a pytree of tensors).  `run(inputs)` copies the inputs into the
buffers and evaluates `fn(buffers)`:

* on CUDA the first run is eager (it loads the libraries and their
  handles), the second captures `fn` with `control.graph_capture` and
  replays the graph, and every later run replays it.  The outputs are
  clones: the next replay overwrites the graph's own.  A failed capture
  raises; there is no eager fallback on the card;
* on the CPU every run is eager on the same buffers, so the tests reach
  the code the card captures.

`events` (a Counter shared by the programs of one kind) counts the
eager runs, captures and replays on CUDA, under "eager", "capture" and
"replay", or "<label> eager", ... for a program with a label.
"""

from __future__ import annotations

from collections import Counter

import torch
from torch.utils import _pytree as pytree

from vslam_tpu_torch.ops import control


class StaticProgram:
    def __init__(self, fn, buffers, events: Counter, label: str = ""):
        self.fn, self.buffers, self.events = fn, buffers, events
        self.prefix = f"{label} " if label else ""
        self.device = pytree.tree_leaves(buffers)[0].device
        self.uses = 0
        self.graph = None
        self.out = None  # the captured graph's outputs
        self.record = None  # control.Record of the capture

    def eager(self):
        """fn on the buffers as they stand, eagerly (no event counted)."""
        return self.fn(self.buffers)

    def load(self, inputs) -> None:
        """Copy `inputs` (the buffers' pytree structure; CPU or device
        tensors, or numpy arrays) into the buffers.  Host data goes
        through pinned memory with an asynchronous copy, so loading waits
        for none of the work queued on the card."""
        cuda = self.device.type == "cuda"

        def copy(buf, x):
            x = torch.as_tensor(x)
            if cuda and x.device.type == "cpu":
                x = x.pin_memory()
            buf.copy_(x, non_blocking=True)

        pytree.tree_map(copy, self.buffers, inputs)

    def capture(self) -> None:
        """Capture fn over the buffers (CUDA; after one eager run)."""
        if self.device.type != "cuda" or self.uses == 0:
            raise RuntimeError("StaticProgram.capture: needs one eager run on CUDA first")
        graph = torch.cuda.CUDAGraph()
        with control.graph_capture(graph, self.device) as record:
            self.out = self.fn(self.buffers)
        self.graph, self.record = graph, record
        self.events[self.prefix + "capture"] += 1

    def run(self, inputs=None):
        """Load `inputs` (None: the buffers as they stand) and evaluate."""
        if inputs is not None:
            self.load(inputs)
        return self.evaluate()

    def evaluate(self):
        """fn on the buffers as they stand: eagerly, captured or replayed
        (the module docstring's rule)."""
        if self.device.type != "cuda":
            out = self.fn(self.buffers)
        elif self.uses == 0:
            out = self.fn(self.buffers)
            self.events[self.prefix + "eager"] += 1
        else:
            if self.graph is None:
                self.capture()
            self.graph.replay()
            self.events[self.prefix + "replay"] += 1
            out = pytree.tree_map(torch.clone, self.out)
        self.uses += 1
        return out

    def warm(self) -> None:
        """Run until captured (CUDA; once on the CPU) on the buffers as
        they stand, and wait for the card."""
        self.evaluate()
        if self.device.type == "cuda":
            if self.graph is None:
                self.evaluate()
            torch.cuda.synchronize(self.device)
