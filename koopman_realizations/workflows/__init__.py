from koopman_realizations.workflows.rand_models import evaluate_rand_models  # noqa: F401
