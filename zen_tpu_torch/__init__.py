"""zen_tpu_torch: the PyTorch/CUDA port of zen-tpu for NVIDIA Hopper.

A second package beside the JAX reference ``zen_tpu``, with the same
module names. It carries the causal streaming HPR (the realtime main
path) and the two-pass offline HPR-I with its blocked overlap-save
form: windows, config, framing, the spectral engine on ``torch.fft``,
and the two hand-written CUDA median kernels of ``csrc/`` (plain
PyTorch twins on CPU tensors); around them the ``zen-torch`` CLI, audio
file I/O over the repository's native codecs, checkpoints, the live
ring-buffer service, the resumable corpus driver with its pipelined
cascade, the reference's two demo apps (``apps``), and the single-host
parallel layer (``parallel``: a mesh of devices, dp x sp and frequency-tp
sharded drivers). It imports torch and never jax.
"""

from .convert import (  # noqa: F401
    config_from_fields,
    state_from_numpy,
    state_to_numpy,
)
from .drivers.offline import (  # noqa: F401
    HPRIOffline,
    hpr_separate,
    hpr_separate_blocked,
)
from .drivers.realtime import (  # noqa: F401
    HPRRealtime,
    MultiStreamHPR,
    StreamState,
    block_step,
    init_state,
)
from .engine.config import (  # noqa: F401
    OUTPUT_ALL,
    OUTPUT_HARMONIC,
    OUTPUT_PERCUSSIVE,
    OUTPUT_RESIDUAL,
    HPRConfig,
)
from .errors import ZenError  # noqa: F401
from .parallel.mesh import default_mesh, make_mesh  # noqa: F401
from .parallel.sharded import (  # noqa: F401
    sharded_hpri_blocked,
    sharded_hpri_offline,
    sharded_separate,
    sharded_separate_blocked,
    tp_hpri_offline,
)

__version__ = "0.1.0"
