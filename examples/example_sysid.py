"""Train linear, bilinear, and nonlinear Koopman realizations of the 3-link
arm and compare validation rollouts (reference ``example_sysid.m``).

Trains on the in-repo arm corpus (``utils.data.generate_arm_data``)
unless ``--datafile`` names a datafile.

Run:  python examples/example_sysid.py [--datafile PATH] [--save DIR]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from koopman_realizations.config import SysidConfig
from koopman_realizations.models.edmd import Ksysid
from koopman_realizations.utils.checkpoint import save_model
from koopman_realizations.utils.data import generate_arm_data
from koopman_realizations.utils.matio import load_data4sysid
from koopman_realizations.utils.naming import model_classname


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--datafile", default=None)
    ap.add_argument("--save", default=None, help="directory to save models")
    args = ap.parse_args()

    data = load_data4sysid(args.datafile) if args.datafile \
        else generate_arm_data(seed=0)
    models = {}
    for model_type in ("linear", "bilinear", "nonlinear"):
        cfg = SysidConfig(model_type=model_type, time_type="discrete",
                          obs_type=("poly",), obs_degree=(3,),
                          snapshots=np.inf, lasso=(np.inf,), delays=0,
                          dim_red=True)
        ks = Ksysid(data, cfg).train_models()
        res = ks.val_model(ks.model, ks.valdata[0])
        err = res["error"]
        print(f"{model_type:9s}: N={ks.N:3d}  "
              f"NRMSE={np.round(np.asarray(err['nrmse']), 4)}  "
              f"mean euclid={float(err['euclid_mean']):.4f}")
        models[model_type] = ks
        if args.save:
            name = model_classname(model_type, "poly", 3, ks.n, ks.m, ks.nd)
            path = save_model(os.path.join(args.save, name), ks.model,
                              scaler=ks.scaler)
            print(f"          saved -> {path}")
    return models


if __name__ == "__main__":
    main()
