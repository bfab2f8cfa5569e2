from koopman_realizations.control.kmpc import (  # noqa: F401
    BilinearKmpc,
    LinearKmpc,
    NonlinearKmpc,
    make_kmpc,
)
from koopman_realizations.control.ksim import (  # noqa: F401
    Ksim,
    KoopmanPlant,
    run_model_simulation,
)
from koopman_realizations.control.observer import make_load_observer  # noqa: F401
