"""Data wrangling utilities (reference class ``Data``).

Static helpers mirroring ``Data.m``: resample to a new timestep, chop a long
recording into trials, and pack train/val splits into a DataSet
(``get_data4sysid``).  Host-side numpy -- these run once at corpus-prep time.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from koopman_realizations.types import DataSet, Trial, merge_trials


def resample(trial: Trial, Ts: float) -> Trial:
    """Linear-interpolation resampling (``Data.resample:20-37``)."""
    t = np.asarray(trial.t)
    tq = np.arange(t[0], t[-1] + 1e-12, Ts)

    def interp(v):
        if v is None:
            return None
        v = np.asarray(v)
        return np.stack([np.interp(tq, t, v[:, j]) for j in range(v.shape[1])],
                        axis=1)

    return Trial(t=tq, y=interp(trial.y), u=interp(trial.u),
                 x=interp(trial.x), w=interp(trial.w))


def chop(trial: Trial, num: int, length_s: float) -> List[Trial]:
    """Split one long recording into ``num`` trials of ``length_s`` seconds
    (``Data.chop:40-67``; the chop length is capped at duration/num)."""
    t = np.asarray(trial.t)
    Ts = float(np.mean(np.diff(t)))
    maxlen = t[-1] / num
    length_s = min(length_s, maxlen)
    lenk = int(np.sum(t < length_s))
    maxlenk = int(np.sum(t < maxlen))
    # guard the reference's arithmetic: when the duration doesn't divide
    # evenly the MATLAB index set would overrun the recording
    maxlenk = min(maxlenk, len(t) // num)
    lenk = min(lenk, maxlenk)

    out = []
    for i in range(num):
        idx = i * maxlenk + np.arange(lenk)
        pick = lambda v: None if v is None else np.asarray(v)[idx]
        out.append(Trial(t=np.arange(lenk) * Ts, y=pick(trial.y),
                         u=pick(trial.u), x=pick(trial.x), w=pick(trial.w)))
    return out


def get_data4sysid(train: List[Trial], val: List[Trial],
                   params: Optional[dict] = None) -> DataSet:
    """Pack train/val trial lists (``Data.get_data4sysid:93-143``)."""
    return DataSet(train=list(train), val=list(val), params=params)


def generate_arm_data(trials: int = 15, tf: float = 60.0, Tramp: float = 2.5,
                      n_val: int = 5, seed: int = 0, cfg=None) -> DataSet:
    """Arm excitation corpus from a seed (reference ``Arm_setup.m`` +
    ``Arm.simulate_rampNhold`` + ``Data.get_data4sysid``).

    Defaults give the shape class of the reference's arm datafile: 15
    ramp-and-hold trials of 60 s, the last ``n_val`` kept for validation.
    All trials run as one vmapped batch, pinned to the host CPU so that the
    corpus (and every model trained on it) is the same whichever
    accelerator the process also holds.
    """
    import jax

    from koopman_realizations.config import ArmConfig
    from koopman_realizations.models.arm import Arm

    cfg = cfg or ArmConfig(Nmods=3, nlinks=1, L=1.0, m=0.1,
                           output_type="markers", substeps=5)
    arm = Arm(cfg)
    n_val = max(1, min(n_val, trials - 1))   # >=1 train AND >=1 val trial
    rng = np.random.default_rng(seed)
    with jax.default_device(jax.devices("cpu")[0]):
        sims = arm.simulate_rampNhold_batch(rng, tf=tf, Tramp=Tramp,
                                            W=np.zeros((trials, 2)))
    all_trials = [Trial(t=s["t"], y=s["y"], u=s["u"], x=s["x"], w=s["w"])
                  for s in sims]
    return get_data4sysid(all_trials[:-n_val], all_trials[-n_val:],
                          params={"sysName": "arm-generated",
                                  "Nmods": cfg.Nmods, "Ts": cfg.Ts})


def merge_files(datasets: List[DataSet]) -> DataSet:
    """Concatenate several DataSets' splits (``Data.merge_files:70-90``)."""
    train = [tr for ds in datasets for tr in ds.train]
    val = [tr for ds in datasets for tr in ds.val]
    params = datasets[0].params
    return DataSet(train=train, val=val, params=params)


__all__ = ["resample", "chop", "get_data4sysid", "generate_arm_data",
           "merge_files", "merge_trials"]
