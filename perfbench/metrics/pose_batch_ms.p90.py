"""90th percentile, over every handle completed in the window, of the
host's wall time from handing the handle to SlamEngine.process_prestaged
to its frames' poses on the host (the call's return)."""

import numpy as np


def read(w):
    return 1e3 * float(np.percentile(w.handle_s, 90)) if w.handle_s else None
