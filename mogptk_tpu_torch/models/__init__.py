"""Named models over a DataSet. JAX counterpart: mogptk_tpu/models/."""
from .sm import SM
from .mosm import MOSM
from .csm import CSM
from .sm_lmc import SM_LMC
from .conv import CONV
from .mohsm import MOHSM
