from koopman_realizations.parallel.mesh import (  # noqa: F401
    data_sharding,
    make_mesh,
    pad_to_multiple,
    replicated,
)
from koopman_realizations.parallel.edmd_sharded import koopman_gram_sharded  # noqa: F401
from koopman_realizations.parallel.scenarios import (  # noqa: F401
    run_batch_sharded,
    sharded_batch_runner,
)
from koopman_realizations.parallel.pca_sharded import pca_feature_sharded  # noqa: F401
