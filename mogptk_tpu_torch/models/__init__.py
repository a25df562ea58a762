"""Named models over a DataSet. JAX counterpart: mogptk_tpu/models/; only
MOSM is ported so far (the others are ROADMAP queue 1, item 6)."""
from .mosm import MOSM
