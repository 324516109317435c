"""What the timed path produces, kept for the check after the window.

``Recorder`` wraps the program's K1 and K2 entry points (the functions
every launch, single or with a lane axis, goes through): while it is on,
a sample of calls drawn from the seed keeps a copy of its inputs and
outputs, and, in the traced slice, every call keeps what its least time
needs (shapes and the number of gated-in pairs). No sample is kept in
the slice, so no copy runs inside the ops it times. The calls
themselves run as they would.
"""
from __future__ import annotations

import random

import torch

INT32 = torch.int32


class Recorder:
    def __init__(self, seed: int, sample: dict):
        self.rng = random.Random(f"portbench-calls-{int(seed)}")
        self.k1_share = float(sample.get("k1_share", 0.1))
        self.k1_max = int(sample.get("k1_max", 48))
        self.k2_share = float(sample.get("k2_share", 0.1))
        self.k2_max = int(sample.get("k2_max", 24))
        self.on = False           # keep a sample (the timed window)
        self.slice = False        # keep every call's work (traced slice)
        self.k1_calls, self.k2_calls = [], []
        self.k1_work, self.k2_work = [], []
        self.k1_seen = self.k2_seen = 0
        self._undo = []

    # -- wrapping ---------------------------------------------------------
    def install(self):
        from slam_dynamic_tpu_torch.ops import gated_match as gm
        from slam_dynamic_tpu_torch.ops import hamming as hm
        k1, k2 = gm._k1, hm._launch_k2

        def rec_k1(plain, kp_args, lm_args, lvl_min, lvl_max):
            out = k1(plain, kp_args, lm_args, lvl_min, lvl_max)
            self._k1(kp_args, lm_args, lvl_min, lvl_max, out)
            return out

        def rec_k2(a, b):
            out = k2(a, b)
            self._k2(a, b, out)
            return out
        gm._k1, hm._launch_k2 = rec_k1, rec_k2
        self._undo.append(lambda: (setattr(gm, "_k1", k1),
                                   setattr(hm, "_launch_k2", k2)))
        # K2 on CPU tensors (tests, rehearsals) never reaches the launch
        plain = hm.hamming_matrix_plain

        def rec_plain(a, b):
            out = plain(a, b)
            if a.device.type == "cpu":
                self._k2(a, b, out)
            return out
        hm.hamming_matrix_plain = rec_plain
        self._undo.append(lambda: setattr(hm, "hamming_matrix_plain", plain))

    def uninstall(self):
        while self._undo:
            self._undo.pop()()

    def k1_slice_work(self):
        """Per K1 call of the traced slice: (lanes, n, m, gated-in
        pairs), the pairs with both ok flags set."""
        out = []
        for kp_ok, lm_ok in self.k1_work:
            n, m = kp_ok.shape[-1], lm_ok.shape[-1]
            lanes = kp_ok.numel() // n if n else 1
            pairs = (kp_ok.reshape(lanes, n).sum(1, dtype=INT32).long()
                     * lm_ok.reshape(lanes, m).sum(1, dtype=INT32).long())
            out.append((lanes, n, m, int(pairs.sum())))
        return out

    # -- keeping ----------------------------------------------------------
    def _k1(self, kp_args, lm_args, lvl_min, lvl_max, out):
        if self.slice:
            # the ok flags themselves: counting them here would launch
            # kernels inside the op that the slice times
            self.k1_work.append((kp_args[3], lm_args[4]))
        if not self.on:
            return
        self.k1_seen += 1
        if len(self.k1_calls) < self.k1_max and \
                self.rng.random() < self.k1_share:
            self.k1_calls.append((
                [t.clone() for t in kp_args], [t.clone() for t in lm_args],
                int(lvl_min), int(lvl_max), [t.clone() for t in out]))

    def _k2(self, a, b, out):
        if self.slice:
            lanes = a.shape[0] if a.dim() == 3 else 1
            self.k2_work.append((lanes, a.shape[-2], b.shape[-2]))
        if not self.on:
            return
        self.k2_seen += 1
        if len(self.k2_calls) < self.k2_max and \
                self.rng.random() < self.k2_share:
            self.k2_calls.append((a.clone(), b.clone(), out.clone()))
