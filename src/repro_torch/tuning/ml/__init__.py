"""repro_torch.tuning.ml — the paper's ML-based tuning methodology, in the
PyTorch port.

Offline: export labeled (config, time) data from exhaustive sweeps and
TuningDB records, train a pure-numpy random forest per kernel family, save
a versioned ``.npz`` artifact.  Online: ``strategy="ml"`` ranks a
workload's valid candidates through the forest in zero objective
evaluations, falling back to the analytical model when no artifact /
forest exists or tree disagreement is high.

    PYTHONPATH=src python -m repro_torch.launch.tune train-model \
        --out artifacts/ml_model_torch.npz --device cpu --objective cost
    PYTHONPATH=src python -m repro_torch.launch.tune eval-model \
        --model artifacts/ml_model_torch.npz --device cpu --objective cost

    session.tune(wl, method="ml")      # via the strategy registry

The port's own copy of ``repro.tuning.ml``: features, labels, splits, trees
and choices are the same numpy arithmetic, so both packages compute
identical arrays, and an artifact saved by either loads in the other.  The
artifact path comes from ``$REPRO_TORCH_ML_MODEL``.  Labels are times, or
a policy's scalars (``policy=``, see ``repro_torch.core.policy``).
"""
from repro_torch.tuning.ml.dataset import (Dataset, build_dataset, dataset_from_db,
                                           dataset_from_journal,
                                           dataset_from_journal_dir,
                                           merge, parse_db_key, split_by_size,
                                           suite_workloads, sweep_workload, SUITE)
from repro_torch.tuning.ml.evaluate import check_floors, evaluate_model
from repro_torch.tuning.ml.features import (FEATURE_NAMES, FEATURE_VERSION,
                                            N_FEATURES, featurize, featurize_batch)
from repro_torch.tuning.ml.forest import (Forest, MODEL_SCHEMA, ModelArtifactError,
                                          ModelBundle, train_bundle)
from repro_torch.tuning.ml.strategy import (DEFAULT_MODEL_PATH, MLStrategy,
                                            default_model_path, default_strategy)

__all__ = [
    "Dataset", "DEFAULT_MODEL_PATH", "FEATURE_NAMES", "FEATURE_VERSION",
    "Forest", "MLStrategy", "MODEL_SCHEMA", "ModelArtifactError",
    "ModelBundle", "N_FEATURES", "SUITE", "build_dataset", "check_floors",
    "dataset_from_db", "dataset_from_journal", "dataset_from_journal_dir",
    "default_model_path", "default_strategy",
    "evaluate_model", "featurize",
    "featurize_batch", "merge", "parse_db_key", "split_by_size",
    "suite_workloads", "sweep_workload", "train_bundle",
]
