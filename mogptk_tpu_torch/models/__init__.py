"""Named models over a DataSet. JAX counterpart: mogptk_tpu/models/; the SM
model is not ported yet (ROADMAP queue 1, item 9)."""
from .mosm import MOSM
from .csm import CSM
from .sm_lmc import SM_LMC
from .conv import CONV
from .mohsm import MOHSM
