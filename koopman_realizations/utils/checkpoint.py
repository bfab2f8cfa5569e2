"""Model persistence (reference ``Ksysid.save_class:406-450``).

The reference saves the whole class as a ``.mat``; here a trained model is a
pytree + static metadata, saved as a single ``.npz`` with a JSON header
(arrays: A/B/C/K/M, PCA components, gaussian centers, scaler factors) and
reconstructed exactly.  ``export_mat`` writes the A/B/C/K matrices in the
reference's layout so a MATLAB session can cross-validate them directly.
Filenames follow the reference's classname scheme (``utils.naming``), with
``auto_rename`` collision avoidance.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from koopman_realizations.models.koopman import (
    BilinearModel,
    LinearModel,
    ModelMeta,
    NonlinearModel,
)
from koopman_realizations.ops.observables import KoopmanBasis
from koopman_realizations.ops.scaling import Scaler
from koopman_realizations.utils.naming import auto_rename

_MODEL_TYPES = {"LinearModel": LinearModel, "BilinearModel": BilinearModel,
                "NonlinearModel": NonlinearModel}


def save_model(path: str, model, scaler: Optional[Scaler] = None,
               overwrite: bool = False) -> str:
    """Save a trained Koopman model (+ optional scaler) to ``path``.npz."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    if not overwrite:
        path = auto_rename(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    arrays = {}
    header = {
        "class": type(model).__name__,
        "meta": dataclasses.asdict(model.meta),
        "lasso": float(model.lasso),
        "basis": {
            "model_type": model.basis.model_type,
            "n": model.basis.n, "m": model.basis.m, "nd": model.basis.nd,
            "nw": model.basis.nw,
            "families": list(map(list, model.basis.families)),
            "has_centers": model.basis.gaussian_centers is not None,
            "has_pcs": model.basis.pcs is not None,
        },
        "has_scaler": scaler is not None,
    }
    for name in ("A", "B", "C", "M", "K", "W"):
        if hasattr(model, name) and getattr(model, name) is not None:
            arrays[name] = np.asarray(getattr(model, name))
    if model.basis.gaussian_centers is not None:
        arrays["gaussian_centers"] = np.asarray(model.basis.gaussian_centers)
    if model.basis.pcs is not None:
        arrays["pcs"] = np.asarray(model.basis.pcs)
    if scaler is not None:
        for f in dataclasses.fields(scaler):
            v = getattr(scaler, f.name)
            if v is not None:
                arrays["scaler_" + f.name] = np.asarray(v)
    np.savez(path, header=json.dumps(header), **arrays)
    return path


def load_model(path: str):
    """Load a model saved by ``save_model``; returns (model, scaler|None)."""
    data = np.load(path, allow_pickle=False)
    header = json.loads(str(data["header"]))
    basis = KoopmanBasis(
        model_type=header["basis"]["model_type"],
        n=header["basis"]["n"], m=header["basis"]["m"],
        nd=header["basis"]["nd"], nw=header["basis"]["nw"],
        families=tuple(tuple(x) for x in header["basis"]["families"]),
        gaussian_centers=data["gaussian_centers"] if header["basis"]["has_centers"] else None,
        pcs=data["pcs"] if header["basis"]["has_pcs"] else None,
    )
    meta = ModelMeta(**header["meta"])
    cls = _MODEL_TYPES[header["class"]]
    kw = dict(meta=meta, basis=basis, lasso=header["lasso"])
    for f in dataclasses.fields(cls):
        if f.name in ("meta", "basis", "lasso"):
            continue
        kw[f.name] = data[f.name] if f.name in data.files else None
    model = cls(**kw)
    scaler = None
    if header["has_scaler"]:
        skw = {}
        for f in dataclasses.fields(Scaler):
            key = "scaler_" + f.name
            skw[f.name] = data[key] if key in data.files else None
        scaler = Scaler(**skw)
    return model, scaler


def export_mat(path: str, model) -> str:
    """Write A/B/C/K in the reference's model-struct layout (.mat)."""
    import scipy.io as sio

    if not path.endswith(".mat"):
        path = path + ".mat"
    out = {}
    for name in ("A", "C", "M", "K", "W"):
        if hasattr(model, name) and getattr(model, name) is not None:
            out[name] = np.asarray(getattr(model, name))
    if isinstance(model, BilinearModel):
        # back to the reference's (NL, m*NL) column-block layout: model.B
        # is (NL, m, NL), so a C-order reshape already emits the m column
        # blocks in order -- no axis swap is needed
        B = np.asarray(model.B)
        out["B"] = B.reshape(B.shape[0], -1)
    elif hasattr(model, "B") and model.B is not None:
        out["B"] = np.asarray(model.B)
    sio.savemat(path, {"model": out})
    return path
