"""The lock that serialises forward-mode differentiation across threads.

torch.func.jacfwd opens a forward-AD level for the duration of the call,
and those levels are one process-wide table: a second thread entering
jacfwd while the first is inside it finds its level index gone
("Trying to access a forward AD level with an invalid index") and the
process aborts. The background global BA (`mapping/global_ba.py`)
linearizes in its own thread while tracking and mapping linearize in the
caller's, so every jacfwd evaluation in the package holds FORWARD_AD.
"""

import threading

FORWARD_AD = threading.RLock()
