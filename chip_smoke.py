#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``pgdrome_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

It builds the sweep's kernels (the factor kernel, with its fused narrow
product, and the tensor-core GEMM) from ``pgdrome_tpu_torch/csrc`` with nvcc,
loads the committed rank-640 d=5 vademecum (``states/frontier_d5_state.npz``)
onto the card at full width, and serves it through the port's entry points:
fields (f32, streamed, bf16 store), sensors and Monte-Carlo moments, and
takes one moment call apart on the device and host clocks.  It then holds
every kernel wiring against the plain PyTorch version on the same inputs
(the factors bit for bit), the served fields against per-sample FEM at
the 32 inset parameter-box corners.  Phase ``analytics`` then checks the
rest of serving on the same vademecum: ``save`` → ``load``, ``errors``, a
fixed-parameter slice (NP = 3) and the derivative vademecum (a DG1 table of
2048 dofs) through the field kernels, the parameter Jacobian, a batched
Gauss–Newton fit, an MCMC posterior, exact Sobol' indices against
Monte-Carlo moments and a D-optimal sensor design.  Next, phase ``train``
trains the bench vademecum with the port alone (``bench.py:806-881`` at its own widths: a
64-mode f32 greedy stage on the card, two f64 residual restarts of 48
modes, compression to rank 50 and a Galerkin update on the host), holds
it under 1e-6 against per-sample FEM over 8 corners + 3 × (64 random +
16 edge) samples, and serves those samples through the field kernels.
Phase ``frontier`` trains the d=5 vademecum with the port's
``highd_frontier(5)`` at full width (2047 × 129^5, T = 6), cut to its first
stage (128 plain f32 modes), checks it against the JAX record
(``FRONTIER_d5.json``) and serves it through the field kernels.  Phase
``anova`` runs ``highd_frontier(5, anova_order=2)`` from the start of the
JAX record ``FRONTIER_ANOVA_d5.json``: the host f64 ANOVA start (rank 93,
its pair tables checked against the record), stage 1 verifying it, and a
boosted, corner-seeded dd stage cut to 16 modes (the record's 96-mode
stage and its 1e-6 gate are ``run_frontier_torch.py --anova 2 --budget
96``); it holds the dd contraction on the card against the CPU bit for
bit, reloads the checkpoint exactly and serves the result through the
field kernels.
Phase ``certify`` loads the committed rank-2717 d=10 state
(``states/frontier_anova_d10_state.npz``, 2047 × 129^10, T = 11) with no
training: the recipe's screened verification and its final FEM
confirmation at all 1024 inset corners, the dd residual indicator and the
guaranteed field bound, each held against the JAX package's figures on
this state, a certifier attached to the vademecum served through the
field kernels, and the certifier saved and reloaded.  Phase ``dual``
serves goal-oriented outputs of the committed d=10 primal and duals; phase
``transient`` trains the transient conductivity primal on the card, serves
its space-time fields, trains the first stage of the adjoint cascade of its
x0 = 0.5 output (``TRANSIENT_GOAL.json``; the cascade to its 1e-6 bound is
``run_transient_goal_torch.py``) and serves the corrected outputs through
the factor kernel, and certifies a moving heat source.  Phase ``nonlinear``
trains the nonlinear vademecum of ``NONLINEAR.json`` (outer Picard of f32
cascades on the card, dd stacks from the third outer iteration), verifies
it against 76 banded-Newton truths and serves it through the field
kernels.  Phase ``elasticity`` builds the JAX package's one 2D-space
configuration (``bench.py:612-662``, the elasticity-ν flagship: vector P2
on a crossed 24 × 6 mesh, 2426 dofs × 17³) through the setup cache, trains
it on the card (16 f32 modes, one f64 residual restart of 16, Galerkin),
holds both against per-grid-point f64 FEM under 1e-6 and serves it through
the field, vector-sensor and strain wirings; phase ``heat3d`` trains
``examples/heat3d_vademecum.py``'s 3D vademecum (P2 tets, 4913 dofs × 25²)
in f64 on the card, verifies it under 1e-6 and serves its fields and
3D-point sensors.  Phase ``reference`` runs the reference-parity layer:
``examples/reference_style_truss.py``'s truss through ``PGDProblem`` on the
host and ``SeparatedPGD`` in f64 on the card under the amplitude rule,
served through the field and sensor wirings and evaluated again through
``Vademecum.to_pgd``; the d=5 vademecum through ``to_pgd`` and
``PGDErrorComputation`` against FEM; ``bench.py``'s host baseline loop for
3 modes at bench's widths against ``SeparatedPGD``; and ``utils/native``.
It prints the measurements: one line per phase, a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.

Any failed check raises (non-zero exit, no result line); a watchdog turns a
hang into a traceback and a non-zero exit.  Without a CUDA device, or run
outside a checkout of the repository, it exits non-zero at once.
"""

from __future__ import annotations

import faulthandler
import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

WATCHDOG_S = 1150  # the whole run, build included; targets are far below
ROOT = Path(__file__).resolve().parent
STATE = ROOT / "states" / "frontier_d5_state.npz"
NUM_PARAMS = 5
SEED = 20261017
B_FIELDS = 524_288           # one field chunk (4.3 GB of f32 output)
B_BIG = 4 * 1_048_576        # sensor / moment batches
N_STREAM_CHUNKS = 4
N_PTS = 8
U32 = 2.0 ** -24             # unit roundoff of float32
FEM_BOUND = 1e-6             # served fields vs FEM at the inset corners
D5_SERVED_MAX = 8.255e-7     # the d=5 state served by the kernels (on an H100: 8.2548e-7
                             # before the GEMM's FMA head, 6.9328e-7 with its 8 modes)
F64_BOUND = 7.0e-7           # plain f64 reconstruction there (6.93e-7 measured on a CPU)
BF16_REL = 1.6e-2            # bf16 store vs f32, relative to max |f32|
C2_FLOOR = 0.65              # collected sensor stream / one-shot rate, each on its second
                             # call: 0.33 before the collect path's repair, 0.78-0.87 after
                             # (PERF.md 6.1); the aim is 0.8, the floor leaves room for a
                             # slower host
# moments: the kernel and plain paths share every reduction (f32 GEMMs over
# 1M-sample chunks, f64 across chunks) and differ only in the rounding of
# each f32 factor.  The variance is E[u²] − mean² in both, which cancels
# about three digits here (E[u²] / var ≈ 1500), so its gap is held against
# the scale of E[u²], not of var.  Both limits are about ten times the gaps
# measured on an H100 (1.0e-8 and 1.5e-8); no bound is derived for the
# library's reduction order.
MEAN_REL = 1e-6              # |Δmean| ≤ MEAN_REL · max|mean|
VAR_REL = 1e-5               # |Δvar| ≤ VAR_REL · max(var + mean²)
MOMENT_REPS = 5              # timed passes of the moment split
# the train phase: the bench vademecum of bench.py:806-881 at its own widths
TRAIN_BUILD = dict(n_x=1024, n_p=128, num_params=3, degree_x=2, boundary_boost=(16.0, 6))
TRAIN_BUDGETS = (64, 48, 48)  # stage 1, then two f64 residual restarts
TRAIN_DEPLOY = 50            # compressed rank
RHS_BUCKET = 512             # the restarts' rhs stacks, padded as bench.py pads them
VERIFY = dict(n_random=64, seeds=(7, 101, 1234), n_edge=16)  # bench.py:215-272's set
REF_FEM = 7.882e-7           # the JAX reference's max on that set (BENCH_r05.json, a TPU run)
# the frontier phase: highd_frontier(5) at full width, cut to its first stage
FRONTIER = dict(max_stages=1, base_boost=(8.0, 6), window_boost=(16.0, 6))
# the JAX record's verified max at rank 128 (FRONTIER_d5.json, a TPU run)
FRONTIER_REF = 4.465731509726485e-05
# the anova phase: highd_frontier(5, anova_order=2) from the JAX record's
# start (FRONTIER_ANOVA_d5.json, a TPU run: the init's rank 93, then one
# stage of 96 modes to rank 189), cut to a stage 2 of 16 boosted, seeded dd
# modes: the init, stage 1, the dd stage on the card, the checkpoint and the
# served result are checked here.  The record's depth and its 1e-6 gate run
# in `python3 run_frontier_torch.py --anova 2 --budget 96 --out DIR`
# (8.340e-7 at rank 189 on an H100; 64 and 48 modes miss the bound there)
ANOVA = dict(stage_budget=16, max_stages=2)
# the ANOVA init's child process (68-88 s of host f64 on an H100's host)
# starts with the script; phase anova waits for it at most this long
ANOVA_CHILD_WAIT_S = 300
ANOVA_PAIR_RANKS = [7, 8, 7, 7, 7, 7, 8, 7, 7, 7]
ANOVA_SIGMA1 = [0.02863236895562541, 0.01928179392540062, 0.019054835238631464,
                0.01893373610349275, 0.04888067093029092, 0.03840493090169561,
                0.03826840805250316, 0.05022291156501423, 0.04105315658955585,
                0.05175738058940883]
ANOVA_STAGE1 = (0.0005064218711802495, 9.94660790830887e-05)  # corners, interior
ANOVA_REF_MAX = 8.59583417679475e-07                          # rank 189, 96 modes
# the certify phase: the committed rank-2717 d=10 state (FRONTIER_ANOVA_d10.json
# records 7.382e-7 by FEM and a guaranteed 2.2805e-6 over the 1024 corners, on
# the Galerkin-updated best; the state holds the raw combination)
D10 = 10
D10_STATE = ROOT / "states" / "frontier_anova_d10_state.npz"
D10_RECORD_FEM = 7.382e-7
D10_RECORD_BOUND = 2.2805e-6
D10_LAM_MIN_LOWER = 0.003906250000131988  # the record's guaranteed_bound.lam_min_lower
# host f64 figures of this machine against the JAX package's from another
# one: the forward error of two f64 pipelines, counted as this many
# roundings at the condition number of the stiffness (a pentadiagonal
# Cholesky or LU solve, its assembly and the products, on each machine)
F64_ROUNDINGS = 16
# the dd indicator against the direct f64 residual of its own f32 tables
# (tests/test_torch_certify.py's DD_TOL)
DD_DIRECT = 2e-6
# the served dd residuals at 16 corners against the same corners' values in
# the 1,024-corner pass: the f32 norms' rounding depends on the batching
# (measured 1.142e-7 on an H100; ~16 u32 allowed)
SERVED_BATCH_GAP = 1e-6
# the JAX package's figures on this state, computed once on a CPU by
# `PYTHONPATH=. python tests/test_torch_certify.py` (d10_reference): the
# per-sample f64 FEM errors at the 1024 inset corners (in box_corners order),
# and at the 16 corners of D10_SUBSET the dd indicator and
# guaranteed_field_bound(sep_pc, Vs, res, tf=None, nodal_tf=tf)["rel_l2"] (op
# by op, jax.disable_jit()); over all 1024 corners the JAX f32 screener's
# largest and median gap to the dd indicator and its ranking
D10_SUBSET = (0, 1023) + tuple(range(68, 1020, 68))
D10_SCREEN = {"max": 0.56784422143153, "median": 0.14543748074937501, "worst16_in_worst32": 15}
D10_DD = [1.5124056744753034e-06, 1.6666914461893612e-06, 9.609397011445253e-07,
          1.041698510562128e-06, 9.88802071333339e-07, 1.0796002243296243e-06,
          1.1796324770330102e-06, 8.832204230202478e-07, 1.0713993106037378e-06,
          1.046706074703252e-06, 1.3268121392684407e-06, 9.615347380531603e-07,
          9.95826212601969e-07, 8.436680900558713e-07, 9.774790896699415e-07,
          1.1665355259538046e-06]
D10_REL_L2 = [1.693987235748112e-06, 2.280502808249266e-06, 1.12753382173318e-06,
              1.2227561216139584e-06, 1.2126684861748607e-06, 1.267469840005421e-06,
              1.4476125845459896e-06, 1.0837640003154458e-06, 1.3708931167330379e-06,
              1.2289757240284415e-06, 1.6280757378751823e-06, 1.1805277671675234e-06,
              1.2746208371710254e-06, 1.0355202269145095e-06, 1.2513633801130191e-06,
              1.4935707637371564e-06]
D10_FEM = [
    7.52114231879e-07, 3.66644268531e-07, 1.23932826707e-07, 2.40028553359e-07, 3.04008912654e-07,
    2.05153051884e-07, 9.03746969111e-08, 2.25013648653e-07, 2.21563758426e-07, 4.03764937778e-07,
    5.31058725386e-07, 1.59766321907e-07, 1.61020377816e-07, 9.78489467168e-08, 1.30749698052e-07,
    2.49438957404e-07, 3.62593701394e-07, 5.72404520596e-07, 2.75684982364e-07, 4.06706288339e-07,
    1.14879926187e-07, 8.85322318502e-08, 1.45454080031e-07, 4.19077680122e-07, 2.52823174164e-07,
    6.11676153901e-07, 5.64837209728e-07, 1.55154896157e-07, 1.12954359496e-07, 4.13081168857e-07,
    2.11670652468e-07, 1.63596388356e-07, 2.77790253995e-07, 1.71773656975e-07, 4.15596792067e-07,
    1.82686860382e-07, 1.46820640613e-07, 6.29662991413e-07, 3.58306161474e-07, 2.79500252954e-07,
    4.63899218370e-07, 2.51882588929e-07, 2.35562861438e-07, 2.59805862305e-07, 4.33442601044e-07,
    2.50151721485e-07, 1.50817503736e-07, 4.31640580803e-07, 3.87716019659e-07, 2.78499432391e-07,
    3.01041382511e-07, 1.42458493722e-07, 1.41608575657e-07, 1.90576568197e-07, 2.21246602921e-07,
    2.29458140275e-07, 1.79875265730e-07, 2.10863415821e-07, 1.95782641480e-07, 9.81273793600e-08,
    1.89125249593e-07, 3.70987109171e-07, 2.08803382683e-07, 2.47925233571e-07, 1.31888997820e-07,
    2.13985138640e-07, 8.37808075542e-08, 2.18845754151e-07, 7.10253901489e-08, 1.83134850861e-07,
    3.78213289230e-07, 4.40416459873e-07, 4.34686625872e-07, 1.70814724727e-07, 9.74334245291e-08,
    2.72100053733e-07, 2.55829734546e-07, 8.78291836342e-08, 4.85896041802e-07, 1.96572167865e-07,
    2.14907153803e-07, 2.79984206918e-07, 1.92383223186e-07, 4.03121202602e-07, 4.39169052721e-07,
    2.09044884045e-07, 1.92630593882e-07, 2.73094516715e-07, 4.49210184853e-07, 2.17806307625e-07,
    2.83536836588e-07, 2.40559209538e-07, 1.44320355233e-07, 3.06515619392e-07, 4.67147946280e-07,
    2.35704079636e-07, 1.49920965726e-07, 1.70777625576e-07, 2.29313445447e-07, 1.50102758658e-07,
    2.95431140904e-07, 1.50275281237e-07, 2.65970716914e-07, 1.11280600189e-07, 1.96137107555e-07,
    4.72757120443e-07, 2.42423188718e-07, 7.28547185104e-08, 1.37435553342e-07, 1.02407547618e-07,
    2.38501853165e-07, 2.14740306824e-07, 1.94409563927e-07, 1.25423076907e-07, 1.53982347756e-07,
    1.27572618502e-07, 1.70183161322e-07, 2.12049368355e-07, 7.27001533914e-08, 1.27724716488e-07,
    3.31282204581e-07, 3.16461680945e-07, 2.38423158762e-07, 2.87319645973e-07, 2.89835152941e-07,
    1.56484569017e-07, 8.80257281803e-08, 1.09952950526e-07, 5.48664639341e-07, 1.01318691410e-07,
    9.83376591149e-08, 3.55273913382e-07, 1.84882122824e-07, 2.10012419156e-07, 2.07651720683e-07,
    3.64169352304e-07, 2.23529543947e-07, 1.75390685666e-07, 2.36913726077e-07, 2.04456280188e-07,
    1.96939439311e-07, 1.62155584908e-07, 2.79897867896e-07, 4.97911908781e-07, 1.12120293588e-07,
    2.37158237997e-07, 2.94135809091e-07, 4.35965162589e-07, 8.92745265395e-08, 1.48973403744e-07,
    2.95640604408e-07, 1.49445527490e-07, 1.87420358094e-07, 1.00954808639e-07, 5.84124863443e-08,
    3.23513050715e-07, 2.25264260202e-07, 7.48484312929e-07, 3.52449952256e-07, 2.82446692087e-07,
    1.75142329452e-07, 8.27072024524e-08, 1.64171717163e-07, 1.02098622574e-07, 3.57802223217e-07,
    9.59947658610e-08, 1.37474868282e-07, 1.62111528561e-07, 2.16937386237e-07, 2.66315665840e-07,
    2.66666630750e-07, 1.53726718088e-07, 1.01724021353e-07, 3.78444851819e-07, 8.89273414590e-07,
    2.90700391067e-07, 2.63346338554e-07, 1.77792037556e-07, 1.97895776933e-07, 4.41670493926e-07,
    1.06352166408e-07, 2.09482407707e-07, 1.18994492960e-07, 3.55049608149e-07, 3.10986807932e-07,
    1.78712478438e-07, 2.71513703218e-07, 1.20194665654e-07, 1.19726269975e-07, 1.62101948880e-07,
    1.85803432473e-07, 2.19284498330e-07, 2.79353058754e-07, 6.90237995360e-08, 1.81861019250e-07,
    2.43733198780e-07, 2.53548885509e-07, 3.05395098520e-07, 6.94085045315e-08, 1.68771079392e-07,
    5.07805417304e-07, 1.38024537908e-07, 1.73062041364e-07, 2.43910593855e-07, 1.30008653731e-07,
    1.54283887569e-07, 4.62385693724e-07, 3.22545606819e-07, 1.90894439516e-07, 1.62690115836e-07,
    2.54839228175e-07, 1.80932484049e-07, 1.89844440945e-07, 3.11263990604e-07, 3.26838185027e-07,
    1.68796242431e-07, 1.67306007920e-07, 4.92272068126e-07, 4.85431441555e-07, 9.89828984000e-08,
    4.52999817399e-07, 2.57190800714e-07, 1.54809884059e-07, 7.86565427489e-08, 2.35629008613e-07,
    2.02042645827e-07, 2.02652703368e-07, 1.34552505278e-07, 1.20351114535e-07, 1.20030089141e-07,
    7.70790927482e-08, 1.32242300470e-07, 2.75842022092e-07, 2.92241934733e-07, 7.43145513307e-08,
    2.69814857069e-07, 6.87621065633e-08, 1.62421350637e-07, 1.35588241288e-07, 1.30589157214e-07,
    1.42180070459e-07, 3.14808503789e-07, 3.52996033834e-07, 1.70976778393e-07, 1.01972055529e-07,
    1.36714717888e-07, 9.24585932948e-08, 1.39784745788e-07, 2.65819852586e-07, 2.75548075495e-07,
    1.69154767878e-07, 1.66573738121e-07, 1.42320298319e-07, 1.01343667521e-07, 2.68743633464e-07,
    1.63789910780e-07, 1.45057029646e-07, 2.56518249560e-07, 1.33169276120e-07, 1.20176211510e-07,
    5.44732588067e-07, 2.51473273569e-07, 4.29642064336e-07, 3.40882186991e-07, 2.82280512677e-07,
    2.33892728020e-07, 3.10622022148e-07, 3.54771044324e-07, 2.53509390651e-07, 4.23311409508e-07,
    2.20958173185e-07, 2.97258232638e-07, 1.11934013295e-07, 3.76501636235e-07, 2.64828428332e-07,
    5.19854230494e-07, 4.48933828154e-07, 3.76498742132e-07, 3.16699824481e-07, 1.12497912375e-07,
    4.80502742881e-07, 1.41395793597e-07, 2.01739537832e-07, 1.07063641573e-07, 1.90414254224e-07,
    4.11345487860e-07, 2.68372412691e-07, 8.19179692404e-08, 1.97230891430e-07, 3.11095588690e-07,
    3.47487493457e-07, 1.31753192102e-07, 3.08670484896e-07, 4.07806002249e-07, 2.49275832744e-07,
    2.66702028217e-07, 3.26020763685e-07, 1.14477551324e-07, 5.08303493641e-07, 1.38947132128e-07,
    1.74409456286e-07, 1.61160202367e-07, 1.00406208067e-07, 1.04649181046e-07, 2.08506304291e-07,
    2.79098323968e-07, 1.71882804619e-07, 1.96755554631e-07, 2.33173592774e-07, 1.49536438001e-07,
    4.93389131202e-07, 3.33387184721e-07, 2.49325918212e-07, 2.50666207432e-07, 4.25471414578e-07,
    2.20922824129e-07, 1.82175886327e-07, 3.01078351593e-07, 1.07047634763e-07, 7.66856337476e-08,
    1.68561796727e-07, 2.09122083745e-07, 5.83243855460e-07, 1.58469094992e-07, 2.31215244108e-07,
    1.51877245197e-07, 8.39715751121e-08, 3.80382082929e-07, 2.37390661660e-07, 4.07077119539e-07,
    2.80789746032e-07, 1.69602641802e-07, 1.34560132851e-07, 1.43069112367e-07, 1.51355840658e-07,
    1.56624298348e-07, 6.12732547738e-07, 2.71758471616e-07, 2.57216308111e-07, 3.34329634879e-07,
    1.83629927702e-07, 9.28737899765e-08, 2.00259356409e-07, 2.48577100413e-07, 1.37414943077e-07,
    8.66863746219e-08, 1.37175581625e-07, 1.99221934486e-07, 3.05335184465e-07, 3.19315098921e-07,
    3.53768425624e-07, 3.10762133435e-07, 2.26587299855e-07, 1.05102968903e-07, 3.49458581529e-07,
    1.00235159758e-07, 1.76502051547e-07, 1.89854075825e-07, 1.57828616473e-07, 4.95972990017e-07,
    2.20917626526e-07, 2.05297917921e-07, 3.26104592831e-07, 2.59529382784e-07, 1.85820916697e-07,
    5.09551129193e-07, 1.89464988164e-07, 6.65092661330e-07, 2.53540187906e-07, 2.10853003223e-07,
    1.16241960853e-07, 3.46373633746e-07, 1.47178688629e-07, 1.43850710533e-07, 1.22595786436e-07,
    3.93276315499e-07, 1.84212768376e-07, 2.37096872067e-07, 2.55899705628e-07, 4.26147079119e-07,
    2.20554846069e-07, 4.21569215525e-07, 4.50002575190e-07, 8.35155151463e-08, 1.95701490517e-07,
    1.38845850407e-07, 1.13274628449e-07, 1.63218608628e-07, 4.35489586758e-07, 4.21459643639e-07,
    3.75560549876e-07, 9.96161254241e-08, 2.19638709974e-07, 2.02056388843e-07, 1.62860882895e-07,
    2.25316588849e-07, 7.91928725809e-08, 2.56247502617e-07, 2.04880585232e-07, 2.49985039371e-07,
    9.78447049812e-08, 9.41819742811e-08, 1.44478201170e-07, 7.25603250798e-08, 1.42284997145e-07,
    3.06727819766e-07, 2.68166038428e-07, 1.42223866007e-07, 2.55929108636e-07, 1.95312300225e-07,
    1.69401051983e-07, 6.65574222316e-08, 2.51070157833e-07, 1.85001971471e-07, 2.04480781507e-07,
    1.51489714319e-07, 1.95592584477e-07, 3.69300749436e-07, 1.88611611071e-07, 2.41671550985e-07,
    1.21170218312e-07, 2.59360956446e-07, 2.31108426023e-07, 3.96433004145e-07, 1.13075388056e-07,
    1.90622281978e-07, 3.93717247509e-07, 3.15526730944e-07, 1.52090297903e-07, 1.46060877270e-07,
    1.86135503213e-07, 4.99292704988e-07, 2.18275231841e-07, 6.57060011328e-08, 3.37838724835e-07,
    1.25597450049e-07, 2.20847127273e-07, 4.00003702176e-07, 1.59668138661e-07, 2.72199770006e-07,
    2.47815435486e-07, 2.15430082702e-07, 5.09510407033e-07, 2.56285412393e-07, 9.15639108694e-08,
    4.20704599814e-07, 3.52031225123e-07, 2.22517767767e-07, 1.61955843775e-07, 7.36584541589e-08,
    1.55187602630e-07, 1.05371517789e-07, 1.62009796147e-07, 1.02528029723e-07, 5.09130619046e-07,
    3.14644974844e-07, 1.98537945775e-07, 7.90448279086e-08, 4.41797650339e-07, 2.11921968821e-07,
    3.24243014172e-07, 2.74113999208e-07, 2.73347588922e-07, 4.20233695494e-07, 2.53339491462e-07,
    1.48820422933e-07, 3.48023828326e-07, 2.40679540452e-07, 1.92829248221e-07, 4.59700565216e-07,
    1.04971600394e-07, 2.71009190937e-07, 1.00551528871e-07, 1.02297330815e-07, 2.39104912570e-07,
    4.56589259694e-07, 2.18936768027e-07, 5.69526885357e-07, 2.89542169520e-07, 2.23142552470e-07,
    3.64595032798e-07, 1.06672447796e-07, 4.07220809519e-07, 1.00552567219e-07, 2.43559609792e-07,
    3.30234142766e-07, 5.74437000494e-08, 1.76588089506e-07, 3.18799021520e-07, 3.86651035978e-08,
    1.49243675000e-07, 1.01153745828e-07, 2.05587536090e-07, 3.79360092594e-07, 3.46045883963e-07,
    8.55298304619e-08, 1.27311714502e-07, 3.13912750222e-07, 1.53333364557e-07, 3.50648946976e-07,
    2.41867839988e-07, 2.89787424192e-07, 1.54045949943e-07, 3.39304035999e-07, 1.88121192386e-07,
    2.12777402304e-07, 2.50868461467e-07, 2.25455914672e-07, 3.48631474000e-07, 1.94779822401e-07,
    1.54384376260e-07, 2.22304919778e-07, 3.95160609024e-07, 9.06057985969e-08, 5.27262415838e-08,
    3.99971967251e-07, 1.08445212610e-07, 8.35782733771e-08, 1.77779892551e-07, 1.20890873668e-07,
    1.07087042641e-07, 1.96836929240e-07, 2.05500943038e-07, 2.14008033241e-07, 3.90539774706e-07,
    1.40300694360e-07, 1.00206683044e-07, 3.62265205439e-07, 2.44116250349e-07, 1.31167331559e-07,
    1.54206966635e-07, 1.38645146877e-07, 1.87984270875e-07, 3.06107988367e-07, 1.10097995761e-07,
    1.76123591222e-07, 2.04574612693e-07, 9.36283061624e-08, 1.61324185488e-07, 2.21887839805e-07,
    1.04423651281e-07, 2.46202431856e-07, 2.02388055808e-07, 2.62272440698e-07, 1.63203980930e-07,
    5.46450462424e-07, 8.80769681498e-08, 2.57241334917e-07, 6.04430679511e-07, 1.63451615882e-07,
    1.35425557519e-07, 2.25737394663e-07, 2.80049317883e-07, 1.67222659958e-07, 2.13731468648e-07,
    1.60405935027e-07, 3.66433685241e-07, 1.69115931463e-07, 7.16758726732e-08, 1.06619224198e-07,
    1.79380290431e-07, 1.79129152899e-07, 1.07204941771e-07, 3.29733631935e-07, 1.73046500071e-07,
    2.73817238343e-07, 4.35100715169e-07, 1.59712732468e-07, 1.44356941090e-07, 2.07963140719e-07,
    1.84101235861e-07, 1.04314669742e-07, 1.35876326061e-07, 1.53341244938e-07, 2.04617170930e-07,
    1.58515967637e-07, 3.42824041068e-07, 3.15996951729e-07, 9.74991099336e-08, 2.10031941434e-07,
    3.46611192093e-07, 2.64622698717e-07, 2.20690320573e-07, 5.50262995696e-08, 1.03584431807e-07,
    2.37291042604e-07, 1.28237971334e-07, 1.49732209879e-07, 1.58157798023e-07, 1.82896667499e-07,
    1.69826522262e-07, 1.95754000313e-07, 1.08809466125e-07, 2.91950894748e-07, 3.23470076606e-07,
    4.45294687970e-07, 1.09600792587e-07, 4.36400145048e-07, 1.36015329722e-07, 2.57955609030e-07,
    7.53206736018e-08, 3.22011248750e-07, 1.45792912888e-07, 1.61855261538e-07, 2.58532428364e-07,
    2.94556647263e-07, 3.21572367261e-07, 1.09983617247e-07, 3.19627777653e-07, 1.94124308676e-07,
    1.91754392527e-07, 2.36536691235e-07, 1.60788554035e-07, 3.80802420415e-07, 1.02588886645e-07,
    1.84119395429e-07, 5.89500169119e-08, 4.93730863603e-07, 1.87358308298e-07, 1.30563198039e-07,
    1.20442987109e-07, 4.99457261543e-07, 1.08909839870e-07, 1.43749399744e-07, 2.50727939110e-07,
    2.02246544752e-07, 3.09244969750e-07, 2.15231090023e-07, 1.98984686266e-07, 6.75533300566e-08,
    9.74529491213e-08, 1.19950679401e-07, 2.07940160207e-07, 1.01879441805e-07, 2.67815672425e-07,
    4.15097878828e-07, 4.37998839437e-07, 3.84947509545e-07, 6.78872315865e-08, 4.12582140792e-07,
    2.53046088752e-07, 8.71536406714e-08, 1.85731471495e-07, 3.06285479654e-07, 1.11367501973e-07,
    4.84835367738e-07, 1.73559263638e-07, 5.08265319383e-07, 8.03322087331e-08, 2.12525172155e-07,
    3.51243386487e-07, 1.77573136902e-07, 3.41901436843e-07, 3.28942823742e-07, 8.72273990763e-08,
    7.18508259714e-08, 3.56399558681e-07, 3.00175974983e-07, 3.06689666878e-07, 1.10234522100e-07,
    2.98264522828e-07, 2.02919134310e-07, 1.44129128401e-07, 3.74241251062e-07, 1.35594920926e-07,
    2.25781632702e-07, 1.40946729794e-07, 1.47700371184e-07, 4.16194738363e-07, 3.33065409713e-07,
    2.63917762320e-07, 1.13659919631e-07, 3.38998896866e-07, 1.20727069111e-07, 9.27140779048e-08,
    2.76823027780e-07, 4.33009624395e-07, 1.03413395005e-07, 3.06210636103e-07, 2.68440172192e-07,
    1.64738050677e-07, 7.21409818185e-08, 2.76137350971e-07, 3.54949633011e-07, 4.22683284964e-07,
    2.97515419879e-07, 1.09887144453e-07, 1.21261522034e-07, 2.55236977543e-07, 3.32775674464e-07,
    1.01399067778e-07, 3.81114005716e-07, 1.34640888127e-07, 1.24357863805e-07, 1.30424702140e-07,
    2.74161143501e-07, 1.12773971758e-07, 2.51139906631e-07, 2.01603554888e-07, 1.87636232650e-07,
    2.66717172786e-07, 7.48911777800e-08, 1.98876581507e-07, 4.66381141703e-07, 4.86807924148e-07,
    1.97399995583e-07, 3.29638702244e-07, 2.17649467705e-07, 8.54718908132e-08, 5.00457172514e-07,
    3.20953653221e-07, 1.72875537542e-07, 1.85619997969e-07, 2.76706800821e-07, 3.27540239056e-07,
    1.85411941145e-07, 1.43044500859e-07, 1.38574882175e-07, 2.75170087650e-07, 1.37056914182e-07,
    1.15090346042e-07, 5.34058840500e-07, 4.73317452306e-07, 1.66639044327e-07, 4.13708057753e-07,
    5.58724901164e-08, 7.15058213666e-08, 2.44102483186e-07, 3.65502832398e-07, 2.08386893393e-07,
    1.29337040732e-07, 1.33800532137e-07, 2.43753462752e-07, 6.02764510488e-07, 3.28338103680e-07,
    2.01602398116e-07, 2.13515377505e-07, 5.71217303169e-07, 3.60156433525e-07, 2.31111893549e-07,
    2.56718024642e-07, 7.69929423824e-08, 1.18011150685e-07, 9.80350857695e-08, 7.44476214381e-08,
    1.40593912633e-07, 2.89412929250e-07, 2.74921488535e-07, 1.03541947622e-07, 4.45959001794e-07,
    1.92443684121e-07, 2.24504687812e-07, 3.14914073448e-07, 1.29970516033e-07, 1.76006031662e-07,
    3.35906978639e-07, 3.87338756666e-07, 1.48972138081e-07, 1.60008653056e-07, 4.18899504475e-07,
    1.16950287672e-07, 1.36135857499e-07, 7.16096576743e-08, 2.10020527645e-07, 4.55899410616e-07,
    2.47176256280e-07, 2.08977375280e-07, 3.39730149582e-07, 1.72600491494e-07, 3.02036588236e-07,
    1.36996082070e-07, 1.39168209347e-07, 2.33719184654e-07, 1.30182521333e-07, 2.85704202086e-07,
    7.05992643264e-08, 3.23640417957e-07, 1.77907170488e-07, 2.19608357836e-07, 1.16923472637e-07,
    2.21913469256e-07, 1.41434223108e-07, 1.17230868978e-07, 2.68524942312e-07, 3.13504664704e-07,
    1.15286645426e-07, 2.61274964919e-07, 9.06724295221e-08, 3.97778283277e-07, 1.97972569431e-07,
    1.74734004601e-07, 1.63807665494e-07, 2.20435285846e-07, 1.59020976876e-07, 1.13423134463e-07,
    4.41374189847e-07, 2.71213187531e-07, 4.22658164421e-07, 2.49441504770e-07, 3.73616415278e-07,
    1.28362917217e-07, 2.42656710665e-07, 1.51091254369e-07, 3.42373939095e-07, 1.06423980498e-07,
    7.04527741907e-07, 2.26143668886e-07, 2.81952113083e-07, 1.98422565728e-07, 3.85456331250e-07,
    1.95651947558e-07, 3.76237036004e-07, 1.58586569545e-07, 2.50556320767e-07, 2.61928440761e-07,
    2.77316121498e-07, 1.53711143119e-07, 1.74438332746e-07, 1.37777090813e-07, 4.11060074198e-07,
    1.76528507923e-07, 1.78784654969e-07, 1.39599879385e-07, 4.97614166995e-07, 1.43999597359e-07,
    2.48991172351e-07, 1.61098306255e-07, 3.71381335653e-07, 1.07718446921e-07, 4.43186639849e-07,
    2.15345448915e-07, 5.11714216231e-07, 5.13299992863e-07, 2.18904272494e-07, 5.37258936301e-08,
    9.87876209156e-08, 3.17844473686e-07, 2.28164594538e-07, 2.00761617713e-07, 3.13952950687e-07,
    7.86608960271e-08, 4.48194465670e-07, 1.90173886364e-07, 3.06319277364e-07, 2.25284527897e-07,
    2.75768352526e-07, 1.32497707569e-07, 1.69326592188e-07, 1.53562560841e-07, 4.69570075747e-07,
    2.97764655050e-07, 2.00189683360e-07, 4.00986651413e-07, 1.15828900781e-07, 3.08085841939e-07,
    1.65390837160e-07, 4.51802180259e-07, 9.00771830455e-08, 8.24532928933e-08, 2.40488739138e-07,
    4.53432686881e-07, 2.13902996847e-07, 1.16641957605e-07, 5.91542400896e-07, 1.60698238387e-07,
    2.08974968256e-07, 1.09533555707e-07, 2.27522290835e-07, 1.61855012395e-07, 3.20659726098e-07,
    1.49463969896e-07, 1.12468388552e-07, 4.26095725180e-07, 3.72074082299e-07, 2.34433394625e-07,
    2.89458968615e-07, 1.20456544481e-07, 2.42931313249e-07, 2.43294142062e-07, 2.87621897081e-07,
    2.35772185699e-07, 1.52144151474e-07, 1.38419759697e-07, 2.81744384536e-07, 1.84794868288e-07,
    5.42206293786e-07, 2.07945587943e-07, 2.45240080036e-07, 2.49452095455e-07, 2.40912481193e-07,
    2.33095945753e-07, 5.58322978866e-08, 1.46447109594e-07, 7.99845435838e-08, 4.52291075152e-07,
    2.03149854742e-07, 3.44600008823e-07, 3.81176846828e-07, 3.19705783730e-07, 8.68324750438e-08,
    1.09506083183e-07, 1.35561196573e-07, 3.52094871638e-07, 3.78293092219e-07, 1.34967538266e-07,
    5.45820010730e-07, 3.40096236749e-07, 1.55428947267e-07, 4.67204875089e-07, 2.05103079630e-07,
    1.20367109623e-07, 2.11198996251e-07, 1.69769325574e-07, 2.58745830895e-07, 1.72040883109e-07,
    3.61512029293e-07, 1.08930235662e-07, 2.39952852424e-07, 1.87562779596e-07, 1.37092389620e-07,
    5.05457057067e-07, 1.18143878804e-07, 1.29151446681e-07, 1.79024965884e-07, 2.04385499315e-07,
    2.05747790653e-07, 1.06712390221e-07, 2.39672655599e-07, 1.74189395399e-07, 2.39356111250e-07,
    3.45736701254e-07, 1.85307927669e-07, 1.08248119996e-07, 2.28934254079e-07, 1.50648537601e-07,
    2.73584733988e-07, 2.14473376176e-07, 1.18575170134e-07, 2.17310499467e-07, 2.60268487001e-07,
    2.32552655108e-07, 1.21746800107e-07, 1.66422263373e-07, 3.28027649575e-07, 8.22109178045e-08,
    1.41035596459e-07, 2.51645539103e-07, 2.73308347053e-07, 1.09760243371e-07, 4.04374211232e-07,
    3.92083267857e-07, 9.29157782333e-08, 1.24346459797e-07, 1.15949101569e-07, 3.07135881407e-07,
    2.49648873938e-07, 2.58512596689e-07, 1.15955628013e-07, 2.86730906729e-07, 1.72974716614e-07,
    2.31363880486e-07, 4.31463973791e-07, 3.04944613091e-07, 4.55854466661e-07, 7.86593305291e-08,
    1.91097956764e-07, 1.29952417665e-07, 1.92355816389e-07, 4.58886290247e-07, 1.56235714838e-07,
    2.02205772888e-07, 9.48577045817e-08, 5.15716327965e-08, 4.09193437891e-07, 2.80190383077e-07,
    1.83930572573e-07, 9.92791655611e-08, 9.30025805416e-08, 2.49129944078e-07, 2.07874437415e-07,
    2.93589023124e-07, 2.64471568923e-07, 9.88739265427e-08, 1.54994892786e-07, 1.76993630947e-07,
    2.31773890116e-07, 3.03475213071e-07, 3.03125101712e-07, 4.11195586932e-07, 6.04540269230e-08,
    3.31836677227e-07, 2.02557495150e-07, 7.14904691537e-08, 1.86270832839e-07, 3.53931630743e-07,
    5.19789270675e-07, 1.58820219104e-07, 9.17989570824e-08, 4.90176597822e-07, 5.39326873301e-07,
    2.18866033802e-07, 5.89498149142e-07, 4.56436624620e-07, 6.33335846538e-08, 1.46187926723e-07,
    3.33436388153e-07, 1.04912547872e-07, 1.57586527153e-07, 9.39053995800e-08, 1.86773752648e-07,
    2.20695698601e-07, 9.23895845096e-08, 2.65114089400e-07, 7.26332484773e-08, 1.20630787018e-07,
    4.93643902319e-07, 6.66841845513e-08, 1.30286794903e-07, 1.34762956653e-07, 3.04658875900e-07,
    3.59955497061e-07, 2.69559095379e-07, 4.76602381319e-07, 1.80430829057e-07,
]
# the analytics phase, on the d=5 vademecum of the serving phases
FIXED = {1: 40 / 128, 3: 88 / 128}   # fix_parameters: two params at interior grid nodes
N_SENS = 16                          # sensor points of the Jacobian, fit and posterior
B_JAC = 65_536                       # Jacobian samples, inside grid cells
# the JAX test's tolerance for the Jacobian against central differences
# (tests/unit/test_serving_analytics.py:38-95): rtol, atol, step
JAC_FD = (1e-5, 1e-6, 1e-7)
B_FIT, FIT_STARTS, FIT_ITERS = 1024, 8, 30
# the fit's gate.  The same fit run by the port in f64 on a CPU at this size
# (`PYTHONPATH=. python tests/test_torch_analytics.py`) recovers every one of
# the 1024 seeded interior parameter sets to 2.3e-13 from the 8 starts: the
# parameters are identifiable, so the f32 fit is held to recovery, by a limit
# that does not depend on p̂.  Let ν be the largest f32 residual norm the
# fit's own arithmetic gives at the true parameters (a fit of n_iter = 0
# from p: the sweep's rounding, the f32 table, the rounding of p and of obs).
# The fit's optimum does no worse than the truth: resnorm ≤ ν (checked).  Its
# f64 residual then is ‖s64(p̂) − obs‖ ≤ resnorm + ‖(s32 − s64)(p̂) − o‖ ≤ 2ν,
# the second term the same rounding at p̂ (o the rounding of obs), and to
# first order in p̂ − p, σ_min(J(p)) ‖p̂ − p‖₂ ≤ ‖s64(p̂) − obs‖₂, so
# ‖p̂ − p‖₂ ≤ FIT_NOISE · ν / σ_min(J(p)).  The same gate on a CPU's f32 fit
# (the script above) passes at 0.32 of the limit after 30 iterations and
# refuses a fit cut to one iteration (303 times the limit).
FIT_NOISE = 2
POST_CHAINS, POST_SAMPLES = 64, 1000
MCMC_STEPS = 1000                    # the sampler's chain steps timed alone
POST_SIGMA = 1e-3                    # σ = POST_SIGMA · max|obs|
N_CANDIDATES, N_DESIGN = 256, 8
MC_SIGMAS = 5                        # Monte-Carlo variance vs Sobol': this many standard errors
# the dual phase: goal-oriented outputs of the committed d=10 primal
# (states/frontier_d10_state.npz, rank 2688, Galerkin-updated on the (8, 6)
# build as recipes.goal_oriented_frontier does) and its committed raw duals
# (rank 384, x0 = 0.5 and 0.25), over the recipe's 1,360-point set
DUAL_PRIMAL = ROOT / "states" / "frontier_d10_state.npz"
DUAL_STATES = [ROOT / "states" / f"frontier_dual_d10_s{j}.npz" for j in (0, 1)]
DUAL_SENSORS = (0.5, 0.25)
DUAL_RATE_B = 65_536        # random in-box samples timed through the card's sweep
DUAL_BOUND_STRIDE = 4       # the guaranteed output bound at every 4th sample (340)
# the JAX package's figures on these files, computed once on a CPU by
# `PYTHONPATH=. python tests/test_torch_dual.py` (d10_dual_reference): per
# sensor the host f64 corrected() outputs' relative error against per-sample
# f64 FEM — max, median, the plain outputs' max — and at every 85th sample
# (16 of them) the corrected output and its error.  FRONTIER_DUAL_d10.json
# records 8.724e-7 / 4.048e-7 on other (Galerkin-updated) duals; not a gate
DUAL_REF = [
    {"max": 8.111967456644473e-08, "median": 3.488206525964857e-09,
     "plain_max": 0.00021455633213929734,
     "s_corr_16": [0.12476804299977814, 0.11493723457457838, 0.11372953330132654,
                   0.10566244378621271, 0.11391732058434022, 0.1122953613253594,
                   0.10479306891392876, 0.11234430507478449, 0.11372628996536431,
                   0.10561584768514755, 0.11136714241672759, 0.10776003099345917,
                   0.10478351800196695, 0.10834067804306191, 0.11351593243111702,
                   0.11170990219175393]},
    {"max": 7.425097467793635e-08, "median": 2.6954333328464114e-09,
     "plain_max": 0.00016617610562508195,
     "s_corr_16": [0.09358242621921917, 0.08651723700694516, 0.08561009265479132,
                   0.0798197189542239, 0.08528330444215806, 0.08488924250775307,
                   0.07877391954083587, 0.08508869404416795, 0.0853591976913793,
                   0.07955706461619433, 0.08391255802398294, 0.08143436354655265,
                   0.07855528797555988, 0.08173080917540991, 0.08520222757574802,
                   0.08446830617054166]},
]
# the transient phase: TRANSIENT_GOAL.json's primal, two_stage_minres(96, 64)
# on transient_parametric_conductivity(n_x=256, n_t=96, n_p=48, 3 params) in
# f32, verified against the exact space-time FOM at the inset box corners and
# 16 random grid points for each of 2 seeds (40 points)
TRANSIENT = dict(n_x=256, n_t=96, n_p=48, num_params=3)
TRANSIENT_STAGES = (96, 64)
TRANSIENT_SOLVE = dict(tol_fp=1e-7, max_fp_it=50)
# the JAX package's figure at this size, its own f32 run on a CPU
# (`PYTHONPATH=. python tests/test_torch_transient.py`): rank 97, field
# relative L2 max over the 40 points (TRANSIENT_GOAL.json: rank 95, 4.77e-4,
# a TPU run).  Its stage 1 keeps 33 of 96 modes: XLA on a CPU (and a TPU)
# flushes f32 denormals to zero, a mode's fixed point collapses and every
# later one repeats it; the port with denormals flushed on a CPU keeps 32,
# and in f64 both packages keep all 96 (amplitudes equal to 3.9e-6 over the
# first 33).  The card keeps denormals: every mode of both stages is held
# kept, and the field error to no more than the reference's at rank 97
TRANSIENT_REF = {"rank": 97, "field_rel_max": 0.00046238485666319224}
# the moving heat source of examples/transient_serving.py with its source
# separated hierarchically to 6.2e-3 (the example's greedy rank-32 split
# leaves a 4.7e-2 floor, which one stage clears), trained by adaptive_minres
# to its bound in restart stages and certified (make_transient_certifier
# covers this (x, t, P, v) family only)
HEAT = dict(n_x=60, n_t=40, n_P=8, n_v=10, af=0.12, source_rank=64,
            separation="hierarchical", separation_tol=1e-6)
HEAT_MINRES = dict(n_stage1=16, stage_budget=10, max_stages=6)
# the transient outputs of TRANSIENT_GOAL.json (recipes.transient_goal_oriented,
# a TPU run on a rank-95 primal: 6.906e-7 at dual rank 192 for x0 = 0.5) on the
# phase's primal and FOM solves: the adjoint cascade's plain first stage of 48
# modes.  Its dd stages (every f32 minres mode runs the 50-sweep cap, the JAX
# package's recipe too) took 120-180 s on an H100: the cascade to the 1e-6
# bound runs in `run_transient_goal_torch.py` (7.078e-7 at dual rank 144 on an
# H100).  The first stage's corrected error is held under STAGE1_CORRECTED,
# twice the 1.236e-5 it measured on an H100 (the record's first stage on its
# TPU primal: 6.146e-6)
TRANSIENT_GOAL = dict(bound=1e-6, dual_stage1=48, dual_budget=48, max_dual_stages=1)
TRANSIENT_X0 = 0.5
TRANSIENT_GOAL_REF = {"stage1_rank": 48, "stage1": 6.146262316486164e-06}
STAGE1_CORRECTED = 2.5e-5
# the nonlinear phase: NONLINEAR.json's recipe as scripts/run_nonlinear.py ran
# it (a TPU run: rank 148 after 4 outer iterations, verified 6.14e-8 against
# 76 banded-Newton truths), the recipe's defaults otherwise (12 outer
# iterations at most, picard_tol 1e-8, cube_rank 40, cube_tol 1e-10, dd stacks
# from outer 3)
NONLINEAR = dict(n_x=1024, n_p=64, num_params=2)
NL_EPS = 2.0
NL_RECIPE = dict(budgets=(64, 48, 48), rhs_bucket=512)
NL_CUBE = dict(cube_rank=40, cube_tol=1e-10)
NL_VERIFY = dict(n_random=16, seeds=(7, 101, 1234), n_edge=8)
NL_REF = {"rank": 148, "outer": 4, "max": 6.141549378408526e-08}
# the elasticity phase: bench.py:612-662's elasticity_nu_phase at its widths
# (2426 space dofs, 2400 free, x 17^3 collocation points, T = 2), trained
# as examples/elasticity_nu_flagship.py does (a 16-mode f32 stage, one f64
# residual restart of 16 modes, Galerkin), verified against per-grid-point
# f64 FEM at the 8 inset corners (grid indices 1 and 15) and 2 seeds x 8
# random inset grid points; the JAX package's recipe on a CPU gives 8.829e-8
# at the corners for the stage and 2.252e-8 after the restart
ELASTICITY = dict(nx=24, ny=6, n_p=16, n_E=16, n_nu=16, degree=2,
                  param_discretization="collocation")
ELAS_E0 = 30000.0            # the builder's E_0, passed explicitly
ELAS_SOLVE = dict(n_max=16, tol=0.0, tol_fp=1e-6, max_fp_it=30, solver="cg", cg_iters=30,
                  residual_check=False)  # in f32
ELAS_RANDOM, ELAS_SEEDS = 8, (7, 101)
ELAS_BATCH = 262_144         # one field batch (2.5 GB of f32 output)
ELAS_STRAIN_BATCH = 65_536
ELAS_SERVE_SLACK = 1.1       # served f32 fields vs FEM: at most 1.1 x the plain f32 version's
# 8 interior sensor points of the 1000 x 100 beam, 2 components each
ELAS_PTS = [[125.0 * (i + 0.5), 25.0 + 50.0 * (i % 2)] for i in range(8)]
# the heat3d phase: examples/heat3d_vademecum.py:46-50 (P2 tets on an 8^3
# box, 4913 dofs, x 25^2, T = 3) trained in f64 on the card, verified at the
# 4 inset corners + 4 random grid points of one seed (the example: 2 seeds x
# 8) and served in f32
HEAT3D = dict(n=8, n_p=24, num_params=2, degree_x=2)
HEAT3D_SOLVE = dict(n_max=30, tol=1e-12, tol_fp=1e-6)  # in f64
HEAT3D_VERIFY = dict(n_random=4, seeds=(7,))
HEAT3D_B = 65_536
# the example's two points, then six more inside the cube
HEAT3D_PTS = [[0.5, 0.5, 0.5], [0.25, 0.5, 0.75], [0.1, 0.1, 0.1], [0.9, 0.2, 0.3],
              [0.3, 0.8, 0.6], [0.75, 0.75, 0.25], [0.5, 0.1, 0.9], [0.15, 0.65, 0.4]]
# the reference phase: examples/reference_style_truss.py's truss (elastic_truss
# at its defaults, P2 on 113 x 2 x 100 elements: 227 x 5 x 201 dofs) through the
# port's PGDProblem with the example's callbacks and the port's SeparatedPGD in
# f64 on the card, served through the field and sensor wirings; the d=5
# vademecum through to_pgd; bench.py:685-760's host baseline for 3 modes at
# bench's widths (TRAIN_BUILD) against SeparatedPGD in f64 on the card
TRUSS_SOLVE = dict(n_max=10, tol=1e-10, tol_fp=1e-5, max_fp_it=50)  # the example's knobs
TRUSS_B = 65_536
TRUSS_PTS = [0.05 + 0.9 * i / 7 for i in range(8)]
TRUSS_EVAL = 64              # served samples evaluated again through to_pgd
BASELINE_MODES = 3
BASELINE_SOLVE = dict(n_max=3, tol=1e-6, tol_fp=1e-6, max_fp_it=30)  # bench.py's knobs
AMP_RTOL = 1e-8              # the amplitude rule (BASELINE.json; test_laplace_fastpath)
AMP_FLOOR = 1e-8             # amplitudes below this fraction of the first are only
                             # held below it on both paths
# the JAX package's own pair (PGDProblem against SeparatedPGD, both f64 on a
# CPU) on the same two builds: its largest relative gap over the amplitudes
# above AMP_FLOOR; a pair of the port that misses AMP_RTOL is held to twice
# it.  Measured by `JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/test_torch_reference_workflows.py` (PERF.md 6.1)
JAX_GAP_TRUSS = 3.3028501905089334e-14     # the truss (1 mode each)
JAX_GAP_BASELINE = 4.562856753990954e-10   # the baseline build, 3 modes
EVAL_REL = 1e-12             # to_pgd evaluations against the f64 plain sweep
PGD_ERR_EQ = 1e-10           # |mean error of return_PGD - of to_pgd| (the truss)
NL_SERVE = 256               # grid points served as the script serves them
# served f32 fields vs the f64 reconstruction's verified max: the d=5 state
# served at K = 640 sat 1.3e-7 (19 %) above its f64 reconstruction at the
# corners before the GEMM's FMA head, 3e-10 with it (PERF.md §6.1); the
# trained frontier results are held to 10 %
FRONTIER_SERVE_SLACK = 1.1

# published dense peaks (NVIDIA data sheets, without sparsity):
# (f32 CUDA-core FLOP/s, TF32 tensor-core FLOP/s, HBM B/s)
PEAKS = {"PCIe": (51e12, 378e12, 2.0e12), "NVL": (60e12, 417.5e12, 3.9e12),
         "SXM": (67e12, 495e12, 3.35e12)}
PEAK_F64 = 34e12             # H100 SXM f64 outside the tensor cores (data sheet)


def say(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def anova_init_child(cache_dir) -> int:
    """The body of the child process that :func:`start_anova_init` starts:
    phase ``anova``'s host f64 ANOVA init (``recipes.frontier_anova_start``
    on the base build's transform, as ``highd_frontier`` forms it) into the
    setup cache at ``cache_dir``.  Exit code 0 when it built the entry."""
    import os

    sys.path.insert(0, str(ROOT))
    from pgdrome_tpu_torch.recipes import frontier_anova_start, frontier_setup

    (_, tf), _ = frontier_setup(NUM_PARAMS, FRONTIER["base_boost"])  # no cache here
    os.environ["PGDROME_SETUP_CACHE"] = str(cache_dir)
    (res, rep), status = frontier_anova_start(NUM_PARAMS, tf, order=2, log=say)
    say(f"anova init child: cache {status}, rank {res.n_modes} in {rep['wall_s']} s")
    return 0 if status == "miss" else 1


def start_anova_init(cache_dir, log_path):
    """Start :func:`anova_init_child` in a child process (2 BLAS threads;
    SIGTERM when this process dies), its output to ``log_path``: the init
    is host work alone, which the phases before ``anova`` leave idle."""
    import ctypes
    import os
    import signal

    env = {k: v for k, v in os.environ.items() if k != "PGDROME_SETUP_CACHE"}
    env.update(OMP_NUM_THREADS="2", OPENBLAS_NUM_THREADS="2", MKL_NUM_THREADS="2")

    def die_with_parent():
        ctypes.CDLL(None).prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG

    with open(log_path, "w") as out:
        return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--anova-init",
                                 str(cache_dir)], stdout=out, stderr=subprocess.STDOUT,
                                env=env, preexec_fn=die_with_parent)


class Phase:
    """Times a phase (ends with a device synchronise) and prints it."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if exc[0] is None:
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0
        say(f"phase {self.name}: {self.seconds:.3f} s"
            + ("" if exc[0] is None else " (failed)"))
        return False


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def host_split(fn, reps=50):
    """Where one call of ``fn`` spends its time: the host's enqueue (the
    call returns before the device is done), the synchronised wall time
    and, from ``torch.profiler`` (CPU and CUDA activities), the device's
    busy time, each per call, and the device's idle share of the wall."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum((getattr(e, "self_device_time_total", None) or e.self_cuda_time_total)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e6 / reps
    return {"host_ms": host * 1e3, "wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
            "idle_share": max(0.0, 1.0 - busy / wall)}


def stream_split(fn):
    """One profiled call of ``fn`` (a stream): its wall time, the device's
    busy time and idle share, and the host operations that took the most
    of it (``torch.profiler``, CPU and CUDA activities), in ms."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):  # the first session starts the tracer
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum((getattr(e, "self_device_time_total", None) or e.self_cuda_time_total)
               for e in events if e.device_type == DeviceType.CUDA) / 1e6
    top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:8]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
            "idle_share": max(0.0, 1.0 - busy / wall),
            "host_ms": {e.key: round(e.self_cpu_time_total / 1e3, 3) for e in top}}


def nvidia_smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def max_sm_clock_hz():
    """The card's highest SM clock (``clocks.max.sm``), in Hz."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(proc.stdout.strip().splitlines()[0]) * 1e6


def clocks():
    """SM clock, power draw and temperature now (a timing's conditions)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def make_samples(torch, B, gen, device):
    """B uniform samples on [0, 1]^NP, with rows pinned at exactly 0 and 1
    per dim and in all dims (the right end must land in the last cell with
    ξ = 1, pgdrome_tpu/ops/pallas_kernels.py:120-122) and at grid nodes."""
    s = torch.rand((B, NUM_PARAMS), generator=gen, device=device)
    s[0] = 0.0
    s[1] = 1.0
    for j in range(NUM_PARAMS):
        s[2 + j, j] = 0.0
        s[2 + NUM_PARAMS + j, j] = 1.0
        s[2 + 2 * NUM_PARAMS + j, j] = 64.0 / 128.0
    return s


def direct_residuals(sep, spaces, res, points):
    """The relative residual ‖b(p) − K(p)u(p)‖/‖b(p)‖ in host f64 at
    parameter grid points, with the coefficient tables and parameter
    factors rounded to f32 as the dd indicator's inputs are (``[0]``) and
    in f64 (``[1]``); ``sep`` the preconditioned problem the modes live
    in."""
    import numpy as np

    M = res.n_modes
    m0 = np.asarray(res.modes[0], dtype=np.float64)[:M]
    ops0 = np.asarray(sep.ops[0], dtype=np.float64)
    rhs0 = np.asarray(sep.rhs[0], dtype=np.float64)
    tabs = []
    for d in range(1, sep.num_dims):
        od = np.asarray(sep.ops[d], dtype=np.float64)
        tabs.append((np.diagonal(od, axis1=1, axis2=2), np.asarray(sep.rhs[d], dtype=np.float64),
                     np.asarray(res.modes[d], dtype=np.float64)[:M]))
    out = np.empty((2, len(points)))
    for i, p in enumerate(points):
        for k, cast in enumerate((lambda a: a.astype(np.float32).astype(np.float64),
                                  lambda a: a)):
            theta, rho, w = np.ones(sep.num_terms), np.ones(sep.num_rhs), np.ones(M)
            for d, (diag, rhs, modes) in enumerate(tabs):
                gi = int(np.argmin(np.abs(spaces[1 + d].tabulate_dof_coordinates()[:, 0]
                                          - p[d])))
                theta = theta * cast(diag[:, gi])
                rho = rho * cast(rhs[:, gi])
                w = w * cast(modes[:, gi])
            u = w @ m0
            b = rho @ rhs0
            r = b - np.einsum("t,tij,j->i", theta, ops0, u, optimize=True)
            out[k, i] = np.linalg.norm(r) / np.linalg.norm(b)
    return out[0], out[1]


def elasticity_truth(Vx, bL, bR, bc_dofs):
    """Per-grid-point f64 FEM of the collocation elasticity-ν flagship:
    ``truth(p)`` at p = (λp, λE, ν) on the parameter grids, where the
    lumped weights cancel, is the fixed-(λp, λE, ν) plane-strain solve
    E_0·λE·(f1(ν)·K1 + f2(ν)·K2) u = λp·(bL + bR) on the free dofs (sparse
    LU).  Neither package ships it: ``examples/elasticity_nu_flagship.py``
    computes it inline."""
    import numpy as np
    from scipy.sparse.linalg import splu

    from pgdrome_tpu_torch.fem.assembly import elasticity_matrix
    from pgdrome_tpu_torch.models.problems import _C1, _C2, _nu_f1, _nu_f2

    K1, K2 = (ELAS_E0 * elasticity_matrix(Vx, C, sparse=True) for C in (_C1, _C2))
    free = np.setdiff1d(np.arange(Vx.dim()), np.asarray(bc_dofs))
    K1, K2 = (K[free][:, free] for K in (K1, K2))
    load = (bL + bR)[free]

    def truth(p):
        u = np.zeros(Vx.dim())
        K = (p[1] * (_nu_f1(p[2]) * K1 + _nu_f2(p[2]) * K2)).tocsc()
        u[free] = splu(K).solve(p[0] * load)
        return u

    return truth


def truss_reference(assembly, bc, solver, problems):
    """examples/reference_style_truss.py's problem, built by the package
    whose modules are passed (``fem.assembly``, ``fem.bc``, ``solver``,
    ``models.problems``): a PGDProblem with the example's callbacks, and the
    same problem as the ``SeparatedProblem`` of ``elastic_truss()`` at its
    defaults.  Returns (problem, separated problem, spaces)."""
    import numpy as np

    sep, vs = problems.elastic_truss()
    gram = assembly.gram
    param = {"A": 1.0, "p_0": 1.0, "E_0": 1.0, "K_x": assembly.stiffness_matrix(vs[0]),
             "M_p": assembly.mass_matrix(vs[1]),
             "M_E_w": assembly.mass_matrix(vs[2], weight=lambda E: E)}
    load = [[assembly.load_vector(vs[0], lambda x: np.ones_like(x))],
            [assembly.load_vector(vs[1], lambda p: p)],
            [assembly.load_vector(vs[2], lambda E: np.ones_like(E))]]

    def bc_fct(Vs, dom, p):
        return [[bc.DirichletBC(Vs[0], 0.0, lambda x: x < 1e-5),
                 bc.DirichletBC(Vs[0], 0.0, lambda x: x > 1 - 1e-5)], 0, 0]

    def lhs(fct_F, var_F, Fs, meshes, dom, p, typ, dim):
        if typ == "r":
            return gram(Fs[1], p["M_p"], Fs[1]) * gram(Fs[2], p["M_E_w"], Fs[2]) * p["K_x"]
        if typ == "s":
            return gram(Fs[0], p["K_x"], Fs[0]) * gram(Fs[2], p["M_E_w"], Fs[2]) * p["M_p"]
        return gram(Fs[0], p["K_x"], Fs[0]) * gram(Fs[1], p["M_p"], Fs[1]) * p["M_E_w"]

    def rhs(fct_F, var_F, Fs, meshes, dom, p, G, PGD_func, typ, nE, dim):
        j, k, d = {"r": (1, 2, 0), "s": (0, 2, 1), "t": (0, 1, 2)}[typ]
        ops = {0: p["K_x"], 1: p["M_p"], 2: p["M_E_w"]}
        out = (Fs[j].array @ G[j][0]) * (Fs[k].array @ G[k][0]) * G[d][0]
        for o in range(nE):
            c = gram(Fs[j], ops[j], PGD_func[j][o]) * gram(Fs[k], ops[k], PGD_func[k][o])
            out = out - c * (ops[d] @ PGD_func[d][o].array)
        return out

    prob = solver.PGDProblem(
        name="truss", name_coord=["X", "P", "E"], modes_info=["U_x", "Node", "Scalar"],
        Vs=vs, bc_fct=bc_fct, load=load, param=param, rhs_fct=rhs, lhs_fct=lhs,
        probs=["r", "s", "t"], seq_fp=[0, 1, 2], PGD_nmax=TRUSS_SOLVE["n_max"])
    prob.stop_fp = "norm"
    prob.norm_modes = "stiff"
    prob.tol_fp_it = TRUSS_SOLVE["tol_fp"]
    prob.max_fp_it = TRUSS_SOLVE["max_fp_it"]
    return prob, sep, vs


def truss_fom(x):
    """The truss's analytic solution u = p/(2E)·(x − x²) at the points x."""
    return lambda data: data[0] / (2 * data[1]) * (x - x ** 2)


def bench_baseline(prob, n_modes, tol):
    """bench.py:685-760's reference-architecture baseline loop on a
    PGDProblem: get_Fsinit, _norm and FP_solve by hand, the 'stiff'
    normalisation, a relative-amplitude stop at ``tol``.  Returns the
    absolute amplitudes (normU) and the host seconds of each mode."""
    import numpy as np

    prob.PGD_func = [list() for _ in range(prob.num_pgd_var)]
    norm_conv, seconds = [], []
    bcs = prob.bc
    while len(seconds) < n_modes:
        t0 = time.perf_counter()
        Fs_init = prob.get_Fsinit(prob.V, bcs, None)
        norm_Fs = np.ones(prob.num_pgd_var)
        for i in range(prob.num_pgd_var):
            norm_Fs[i] = prob._norm(Fs_init[i].array, i, None)
        Fs, norm_Fs = prob.FP_solve(Fs_init, norm_Fs, np.ones(prob.num_pgd_var),
                                    len(seconds), "linear", None, {})
        Fs_n = [f.copy() for f in Fs]
        for d in range(prob.num_pgd_var):
            Fs_n[d].array /= norm_Fs[d]
        a = prob.lhs_fct(Fs_n[-1], Fs_n[-1], Fs_n, prob.meshes, 0, prob.param,
                         prob.prob[-1], prob.num_pgd_var)
        norm_fac = np.sqrt(abs(float(Fs_n[-1].array @ (a @ Fs_n[-1].array)))) ** (
            1.0 / prob.num_pgd_var)
        alpha = float(np.prod(norm_Fs)) * norm_fac ** prob.num_pgd_var
        for d in range(prob.num_pgd_var):
            Fs_n[d].array *= alpha ** (1.0 / prob.num_pgd_var) / norm_fac
            prob.PGD_func[d].append(Fs_n[d])
        norm_conv.append(float(np.prod(norm_Fs)))
        seconds.append(time.perf_counter() - t0)
        if norm_conv[-1] / norm_conv[0] < tol:
            break
    return norm_conv, seconds


def abs_basis_factors(torch, samples, grid, tabs_abs, n_modes):
    """Σ_l |φ_l| |T_l| per dim, multiplied over the dims: the |F| of the
    γ_c bounds.  It equals the plain factors of |T| where every basis value
    is ≥ 0 (P1 inside its cell); P2 bases change sign inside a cell, so
    their absolute values are taken here (the locate and basis of
    ``ops/fused_sweep.py::fused_sweep_plain``, in ``tabs_abs``'s dtype)."""
    dt = tabs_abs.dtype
    s = samples.to(dt)
    g = grid.to(s.device)
    fac = torch.ones((s.shape[0], tabs_abs.shape[2]), dtype=dt, device=s.device)
    for j in range(s.shape[1]):
        t = (s[:, j] - g[0, j].to(dt)) * g[1, j].to(dt)
        c = torch.clamp(torch.floor(t), 0.0, float(g[2, j]) - 1.0)
        xi = t - c
        deg = int(g[3, j])
        base = (deg * c).long()
        basis = ((1.0 - xi, xi) if deg == 1 else
                 ((1.0 - xi) * (1.0 - 2.0 * xi), 4.0 * xi * (1.0 - xi), xi * (2.0 * xi - 1.0)))
        vals = sum(tabs_abs[j][base + l] * b.abs()[:, None] for l, b in enumerate(basis))
        fac *= vals
    fac[:, n_modes:] = 0.0
    return fac


def amplitude_gap(a, b, floor=AMP_FLOOR):
    """The amplitude rule's measures for two traces of absolute mode
    amplitudes (normU of each mode): the largest relative gap over the
    modes both hold above ``floor`` of their first, and the largest
    amplitude, relative to its first, left at or below ``floor`` on either
    path beyond them (0 if none)."""
    import numpy as np

    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    ra, rb = a / a[0], b / b[0]
    big_a, big_b = int(np.sum(ra > floor)), int(np.sum(rb > floor))
    n = min(big_a, big_b)
    gap = float(np.max(np.abs(a[:n] - b[:n]) / np.abs(b[:n]), initial=0.0))
    rest = float(max(np.max(ra[n:], initial=0.0), np.max(rb[n:], initial=0.0)))
    return {"gap": gap, "rest": rest, "above": (big_a, big_b)}


def device_amplitudes(res):
    """The absolute amplitudes (normU) of a SeparatedPGD result's modes."""
    import numpy as np

    return [float(a) * float(res.normU0) for a in np.asarray(res.amplitudes)[:res.n_modes]]


def moment_split(torch, fs, vd, samples):
    """One ``vd.moments(samples)`` call taken apart (serving.py
    ``factor_moments`` and ``moments``, one chunk): building the moment
    function (its first call) on the host clock; the factor kernel,
    ``fac * w``, ``fac.sum(0)`` and ``fac.T @ fac`` on CUDA events (the
    last pass); and on the host clock, over ``MOMENT_REPS`` passes after
    one warm-up, the device work waited for, the copies to the host (f64
    cast included), the host f64 finish and the whole pass, each pass
    followed by a whole warm ``vd.moments`` call so both see the same
    host.  Host times as median, min and max, in ms."""
    from pgdrome_tpu_torch.parallel.vademecum import make_factor_moments_fn

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    make_factor_moments_fn(vd.spaces, vd._modes, vd.n_modes, method=vd._method)
    torch.cuda.synchronize()
    split = {"build_host_ms": (time.perf_counter() - t0) * 1e3,
             "host_threads": torch.get_num_threads(), "reps": MOMENT_REPS}
    sweep = fs.make_fused_sweep(vd.spaces, [None] + list(vd._modes[1:]), vd.n_modes)
    B = int(samples.shape[0])
    parts = ("factor_kernel", "fac_times_w", "fac_sum", "fac_gram")
    host = {k: [] for k in ("device_host", "copies_host", "host_finish", "pass_host",
                            "whole_call_host")}
    for rep in range(MOMENT_REPS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(parts) + 1)]
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        ev[0].record()
        w = (torch.arange(B, device=samples.device) < B).to(torch.float32)
        fac = sweep(samples)
        ev[1].record()
        fac = fac * w[:, None]
        ev[2].record()
        y1 = fac.sum(0)
        ev[3].record()
        y2 = fac.T @ fac
        ev[4].record()
        torch.cuda.synchronize()
        h1 = time.perf_counter()
        s1, s2 = y1.double().cpu() / B, y2.double().cpu() / B
        h2 = time.perf_counter()
        M0 = vd._modes[0].detach().cpu().double()
        mean = s1 @ M0
        cov = s2 - torch.outer(s1, s1)
        var = torch.clamp(torch.einsum("ki,ki->i", cov @ M0, M0), min=0.0)
        h3 = time.perf_counter()
        del fac, w, y2, mean, var
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vd.moments(samples)
        h4 = time.perf_counter()
        if rep == 0:
            continue
        for key, ms in (("device_host", h1 - h0), ("copies_host", h2 - h1),
                        ("host_finish", h3 - h2), ("pass_host", h3 - h0),
                        ("whole_call_host", h4 - t0)):
            host[key].append(ms * 1e3)
    for i, name in enumerate(parts):
        split[f"{name}_ms"] = ev[i].elapsed_time(ev[i + 1])
    for key, v in host.items():
        v = sorted(v)
        split[f"{key}_ms"] = {"median": v[len(v) // 2], "min": v[0], "max": v[-1]}
    return split


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not all(p.is_file() for p in (ROOT / "pgdrome_tpu_torch" / "csrc" / "fused_sweep.cu",
                                       STATE, D10_STATE, DUAL_PRIMAL, *DUAL_STATES)):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # phase anova's host f64 ANOVA init runs in a child process from here on,
    # into the setup cache that phases frontier and anova share
    import atexit
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    anova_log = tmp / "anova_init.log"
    anova_child = start_anova_init(tmp / "setup_cache", anova_log)

    def stop_child():
        if anova_child.poll() is None:
            anova_child.kill()
            anova_child.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop_child)

    # ------------------------------------------------------------- device
    with Phase("device"):
        card = nvidia_smi_line()
        name = torch.cuda.get_device_name(0)
        say(f"card: {card}")
        say(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"cuda {torch.version.cuda}, devices {torch.cuda.device_count()}")
        kind = next((k for k in ("PCIe", "NVL") if k in name), "SXM")
        peak_flops, peak_tf32, peak_bw = PEAKS[kind]
        sm_clock_hz = max_sm_clock_hz()
        say(f"highest SM clock {sm_clock_hz / 1e6:g} MHz (the shared-memory rate of the "
            f"narrow product's bound_smem_ms)")
        say(f"peaks for the roofline ({kind} data sheet): "
            f"{peak_flops / 1e12:g} TFLOP/s f32, {peak_tf32 / 1e12:g} TFLOP/s tf32 "
            f"tensor, {peak_bw / 1e12:g} TB/s")

    from pgdrome_tpu_torch.ops import fused_sweep as fs

    # -------------------------------------------------------------- build
    with Phase("build"):
        info = fs.build(force=True)
        say("nvcc: " + " ".join(info.command))
        say(f"nvcc seconds: {info.seconds:.2f}")
        kernel_name = "?"
        for line in info.log.splitlines():
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                factors = re.search(r"sweep_factors_kernelILi(\d+)ELi(\d)ELb(\d)E", mangled)
                narrow = re.search(r"sweep_narrow_kernelILi(\d+)ELi(\d)ELb(\d)E", mangled)
                if factors:
                    ks, mode, staged = factors.groups()
                    kernel_name = (f"sweep_factors_kernel<ks={ks}, "
                                   f"{('F', 'split')[int(mode)]}, "
                                   f"{'staged' if staged == '1' else 'global'}>")
                elif narrow:
                    ks, nt, staged = narrow.groups()
                    kernel_name = (f"sweep_narrow_kernel<ks={ks}, nt={nt}, "
                                   f"{'staged' if staged == '1' else 'global'}>")
                elif "partial_sum_kernel" in mangled:
                    kernel_name = "partial_sum_kernel<" + (
                        "bf16>" if "bfloat16" in mangled else "f32>")
                else:
                    kernel_name = "sweep_gemm_kernel<" + (
                        "bf16>" if "bfloat16" in mangled else "f32>")
            elif "registers" in line or "spill" in line:
                say(f"  ptxas {kernel_name}: {line.strip().removeprefix('ptxas info    : ')}")
        lib = fs._library()
        say(f"  sweep_gemm_kernel: {lib.pgd_sweep_gemm_smem()} bytes of dynamic shared memory")

    from pgdrome_tpu_torch.convert import frontier_vademecum
    from pgdrome_tpu_torch.models.problems import box_corners, elliptic_fem_solver
    from pgdrome_tpu_torch.serving import Vademecum

    # --------------------------------------------------------------- load
    with Phase("load"):
        vd = frontier_vademecum(STATE, NUM_PARAMS)  # device cuda, method auto
        K, n0 = (int(x) for x in vd._modes[0].shape)
        say(f"vademecum: rank {vd.n_modes}, K={K}, n0={n0}, "
            f"param dofs {[int(m.shape[1]) for m in vd._modes[1:]]}")
        check(vd.n_modes == 640 and n0 == 2049, "d=5 state shape")
        fused = vd._sweep()
        check(isinstance(fused, fs.FusedSweep), "method='auto' took the kernel")

    # ---------------------------------------------------------- FEM truth
    with Phase("fem_truth"):
        grid_p = vd.spaces[1].tabulate_dof_coordinates()[:, 0]
        corners = box_corners(grid_p[1], grid_p[-2], NUM_PARAMS)
        fem = elliptic_fem_solver(vd.spaces[0], NUM_PARAMS)
        u_fem = [fem(p) for p in corners]
        served = vd.fields(corners).double().cpu().numpy()
        vd64 = frontier_vademecum(STATE, NUM_PARAMS, dtype=torch.float64, method="torch")
        plain64 = vd64.fields(corners).cpu().numpy()
        del vd64

        def rel(a, u):
            return max(float(((x - y) ** 2).sum() ** 0.5 / (y ** 2).sum() ** 0.5)
                       for x, y in zip(a, u))

        e_kernel, e_f64 = rel(served, u_fem), rel(plain64, u_fem)
        # the state is verified at the inset corners; at the box faces it is
        # far off by its training, not by serving — printed, not a gate
        faces = box_corners(0.0, 1.0, NUM_PARAMS)
        e_faces = rel(vd.fields(faces).double().cpu().numpy(), [fem(p) for p in faces])
        say(f"fem: kernel f32 max rel-L2 at the box faces p in {{0, 1}}: {e_faces:.6e}")
        say(f"fem: kernel f32 max rel-L2 {e_kernel:.6e} (bound {FEM_BOUND:g}), "
            f"plain f64 {e_f64:.6e} (bound {F64_BOUND:g}) over {len(corners)} corners")
        check(e_kernel < FEM_BOUND and e_kernel <= D5_SERVED_MAX, "kernel-served fields vs FEM")
        check(e_f64 <= F64_BOUND, "plain f64 reconstruction vs FEM")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    s_fields = make_samples(torch, B_FIELDS, gen, dev)
    B_stream = N_STREAM_CHUNKS * B_FIELDS - 4321  # ragged tail
    s_stream = make_samples(torch, B_stream, gen, dev)
    s_big = make_samples(torch, B_BIG, gen, dev)
    pts = [0.05 + 0.9 * i / (N_PTS - 1) for i in range(N_PTS)]
    n_chunks = -(-B_stream // B_FIELDS)
    rates = {}

    # --------------------------------------------- serve: the main path
    with Phase("serve"):
        torch.cuda.synchronize()
        fs.reset_launch_counts()

        # each path is timed on its second call: a first call grows the
        # device allocator (4.3 GB an output block) and, for the sensors,
        # builds the point table or grows the pinned host pool; the first
        # calls' rates are printed beside them
        t0 = time.perf_counter()
        vd.fields(s_fields)
        torch.cuda.synchronize()
        rates["fields/s one-shot, first call"] = B_FIELDS / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        out = vd.fields(s_fields)
        torch.cuda.synchronize()
        rates["fields/s one-shot"] = B_FIELDS / (time.perf_counter() - t0)

        kept = {}

        def keep_ends(y):
            i = len(kept.setdefault("seen", []))
            kept["seen"].append(y.shape[0])
            if i in (0, n_chunks - 1):
                kept[i] = y.clone()

        t0 = time.perf_counter()
        vd.fields_stream(s_stream, consumer=lambda y: y.shape[0], chunk=B_FIELDS, depth=2)
        torch.cuda.synchronize()
        rates["fields/s stream f32, first call"] = B_stream / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        vd.fields_stream(s_stream, consumer=keep_ends, chunk=B_FIELDS, depth=2)
        torch.cuda.synchronize()
        rates["fields/s stream f32"] = B_stream / (time.perf_counter() - t0)

        bf16_blocks = []
        t0 = time.perf_counter()
        vd.fields_stream(s_fields, consumer=lambda y: bf16_blocks.append(y.clone()),
                         chunk=B_FIELDS, depth=2, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        rates["fields/s stream bf16"] = B_FIELDS / (time.perf_counter() - t0)

        t0 = time.perf_counter()
        vd.sensors(pts)(s_big)
        torch.cuda.synchronize()
        rates["sensor samples/s one-shot, first call"] = B_BIG / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        resp = vd.sensors(pts)(s_big)
        torch.cuda.synchronize()
        rates["sensor samples/s one-shot"] = B_BIG / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        vd.sensors_stream(pts, s_big)
        rates["sensor samples/s stream, first call"] = B_BIG / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        resp_stream = vd.sensors_stream(pts, s_big)
        rates["sensor samples/s stream"] = B_BIG / (time.perf_counter() - t0)
        # a caller that keeps its results: each collect call then pins a
        # fresh host block (the result itself), as a first call does
        t0 = time.perf_counter()
        resp_kept = vd.sensors_stream(pts, s_big)
        rates["sensor samples/s stream, earlier result kept"] = (
            B_BIG / (time.perf_counter() - t0))
        check(torch.equal(resp_kept, resp_stream), "a collect call with an earlier result "
              "kept returns the same sensors")
        del resp_kept

        t0 = time.perf_counter()
        mean, var = vd.moments(s_big)
        rates["moment samples/s"] = B_BIG / (time.perf_counter() - t0)
        torch.cuda.synchronize()
        launches = dict(fs.LAUNCHES)
        stage_launches = dict(fs.STAGE_LAUNCHES)
        say(f"launches on the main path: {json.dumps(launches)}")
        say(f"kernel launches on the main path: {json.dumps(stage_launches)}")
        for k, v in rates.items():
            say(f"rate {k}: {v:.6g}")
        say(f"rate sensor responses/s (samples x {N_PTS} points): "
            f"{rates['sensor samples/s one-shot'] * N_PTS:.6g}")
        check(all(v > 0 for v in launches.values()), "every wiring launched on the main path")
        # each field call walks its batch in the wrapper's row chunks and
        # launches the factor kernel and the GEMM once per chunk (the streams
        # pad every dispatch to a full chunk); each sensor call is one launch
        # of the fused narrow product; the factor wiring one of the factor
        # kernel; no table here is wide enough for the global route
        calls = [B_FIELDS] * (2 + 2 * len(kept["seen"]) + 1)
        expected_gemm = sum(len(fs.row_chunks(n, K)) for n in calls)
        say(f"GEMM launches expected from {len(calls)} field calls: {expected_gemm}")
        check(stage_launches["gemm"] == expected_gemm,
              "every field call ran the tensor-core GEMM on every row chunk")
        check(stage_launches["factors_stage"] == stage_launches["gemm"] + launches["factors"],
              "one factor-kernel launch per GEMM launch, plus the factor wiring's")
        # two one-shot calls, then three streams of B_BIG / chunk sensor calls
        chunk = inspect.signature(vd.sensors_stream).parameters["chunk"].default
        sensor_calls = 2 + 3 * -(-B_BIG // chunk)
        say(f"sensor calls expected (two one-shot, three streams of {chunk}-sample "
            f"chunks): {sensor_calls}")
        check(stage_launches["sensor_fused"] == launches["sensors"] == sensor_calls,
              "each sensor call ran the fused narrow product once")
        check(stage_launches["factors_global"] == 0, "the d=5 tables take the staged route")
        check(kept["seen"][-1] == B_stream - (n_chunks - 1) * B_FIELDS, "stream tail trimmed")
        split = moment_split(torch, fs, vd, s_big)
        say(f"moment split: {json.dumps(split)}")
        # C2: where a collected sensor stream and a consumed field stream
        # spend their time (one profiled call each, after the timed ones)
        say("stream split sensors_stream (collect): "
            + json.dumps(stream_split(lambda: vd.sensors_stream(pts, s_big))))
        say("stream split fields_stream (consumer): " + json.dumps(stream_split(
            lambda: vd.fields_stream(s_stream, consumer=lambda y: y.shape[0], chunk=B_FIELDS,
                                     depth=2))))
        c2 = rates["sensor samples/s stream"] / rates["sensor samples/s one-shot"]
        c2_kept = (rates["sensor samples/s stream, earlier result kept"]
                   / rates["sensor samples/s one-shot"])
        say(f"C2: collected sensor stream / one-shot rate {c2:.4f} (the repair's aim 0.8, "
            f"gated at {C2_FLOOR}); with the earlier result kept {c2_kept:.4f}")
        check(c2 >= C2_FLOOR, f"collected sensor stream at {C2_FLOOR}x the one-shot rate or more")

    grid, tabs, m0 = fused.grid, fused.tabs, fused.m0
    check(all(int(d) == 1 for d in grid[3].tolist()), "P1 parameter dims")
    NP = tabs.shape[0]
    ndofp = tabs.shape[1]
    # rounding count of one output (see PERF.md): per dim ≤ 1 in the basis,
    # 2 in Σ_l φ_l T_l and 1 in the product, plus K in the k-sum
    c_fields = K + 4 * NP
    c_factors = 4 * NP
    gamma = lambda c: c * U32 / (1 - c * U32)  # noqa: E731
    kernels = []

    def bf16_ulp(x):
        """The spacing of bfloat16 numbers (8 significant bits) at |x|; the
        smallest subnormal's at 0."""
        e = torch.frexp(x)[1]
        return torch.where(x == 0, torch.full_like(x, 2.0 ** -133),
                           torch.ldexp(torch.ones_like(x), e - 8))

    def located(s, grid):
        """The f64 coordinates that the f32 cell locate of ``s`` finds: per
        dim x0 + t/(1/h) with t = (s − x0)·(1/h) rounded in f32 as the
        kernel and the plain version round it.  Equal to ``s`` where that
        product is exact (the power-of-two grids of the d=5 and d=10
        states); elsewhere the locate moves a sample by ≤ u·|t| cells, a
        shift of the input that the γ_c count of the arithmetic after it
        does not cover."""
        g = grid.to(s.device)
        t32 = (s - g[0]) * g[1]
        return g[0].double() + t32.double() / g[1].double()

    def hold(kernel_out, samples, table, c, rows=65_536, out_dtype=None, sw=None):
        """Max |kernel − plain| (the plain version storing ``out_dtype``) and
        |kernel − plain f64| against the γ_c bound on |F|·|table| (|F| from
        the bases' absolute values, :func:`abs_basis_factors`), on the tables of the
        sweep ``sw`` (default: the d=5 field sweep).  The f64 plain version
        and |F| are evaluated at the coordinates the f32 locate found
        (:func:`located`); the largest shift, in cells, is returned as
        ``locate_cells``.  A bf16 store adds half a bf16 ulp per rounded
        value.  Chunked over rows to bound memory."""
        sw = sw or fused
        grid, tabs, n_modes = sw.grid, sw.tabs, sw.n_modes
        tabs_abs64 = tabs.abs().double()
        worst = {"vs_plain": 0.0, "vs_f64": 0.0, "ratio": 0.0, "locate_cells": 0.0}
        t64 = None if table is None else table.double()
        for r0 in range(0, samples.shape[0], rows):
            s = samples[r0 : r0 + rows]
            s64 = located(s, grid)
            worst["locate_cells"] = max(worst["locate_cells"], float(
                ((s64 - s.double()).abs() * grid.to(s.device)[1].double()).max()))
            k_out = kernel_out[r0 : r0 + rows].double()
            fabs = abs_basis_factors(torch, s64, grid, tabs_abs64, n_modes)
            if t64 is None:
                ref64 = fs.fused_sweep_plain(s64, grid, tabs.double(), None, n_modes)
                plain32 = fs.fused_sweep_plain(s, grid, tabs, None, n_modes)
                # the factor kernel rounds every operation as the plain
                # version does
                check(torch.equal(kernel_out[r0 : r0 + rows], plain32),
                      "factors equal the plain f32 factors bit for bit")
                plain = plain32.double()
                del plain32
                bound = gamma(c) * fabs
            else:
                ref64 = fs.fused_sweep_plain(s64, grid, tabs.double(), t64, n_modes)
                plain = fs.fused_sweep_plain(s, grid, tabs, table, n_modes,
                                             out_dtype).double()
                bound = gamma(c) * (fabs @ t64.abs())
            # plain f32 is within the same γ-bound of the exact value, so the
            # two f32 results are within twice it of each other
            bound64, bound_plain = bound, 2 * bound
            if out_dtype == torch.bfloat16:
                bound64 = bound + bf16_ulp(k_out) / 2
                bound_plain = 2 * bound + bf16_ulp(torch.maximum(k_out.abs(), plain.abs()))
            e64 = (k_out - ref64).abs()
            e_plain = (k_out - plain).abs()
            check(bool((e64 <= bound64).all()), "kernel within its bound of the f64 plain version")
            check(bool((e_plain <= bound_plain).all()),
                  "kernel within twice its bound of the plain version")
            worst["vs_plain"] = max(worst["vs_plain"], float(e_plain.max()))
            worst["vs_f64"] = max(worst["vs_f64"], float(e64.max()))
            worst["ratio"] = max(worst["ratio"], float((e64 / bound64.clamp_min(1e-300)).max()))
        return worst

    def roofline(B, n_out, out_bytes, product, sw=None):
        """Least time for a wiring: each input read once, each output written
        once, over HBM's rate; against the factor FLOPs over the f32 peak
        plus the product's over the TF32 tensor peak (each FLOP counted
        once, not per tf32 pass), whatever unit a kernel runs the product
        on.  ``bound_fp32_ms`` prices every FLOP at the f32 CUDA-core peak
        (the bound of the earlier FP32-pipe kernel, and the price of the
        fused sensor product on the CUDA cores), kept beside it.  Shapes
        from the sweep ``sw`` (default: the d=5 field sweep)."""
        NP, ndofp, K = (sw or fused).tabs.shape
        fac_flops = B * K * 2 * 2 * NP  # P1: 2 mul + 1 add + 1 product mul per dim
        mm_flops = 2 * B * K * n_out if product else 0
        nbytes = (B * NP * 4 + NP * ndofp * K * 4 + 4 * 4 * NP
                  + (K * n_out * 4 if product else 0) + B * n_out * out_bytes)
        t_bytes = nbytes / peak_bw * 1e3
        t_ops = (mm_flops / peak_tf32 + fac_flops / peak_flops) * 1e3
        t_fp32 = (mm_flops + fac_flops) / peak_flops * 1e3
        return {"bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "bound_fp32_ms": max(t_fp32, t_bytes), "flops": fac_flops + mm_flops,
                "bytes": nbytes}

    def stage1_bound(B, sw=None):
        """Least time of a field wiring's factor kernel alone: its inputs read
        once and its split F halves written once over HBM's rate, against
        its factor FLOPs over the f32 peak.  Shapes from the sweep ``sw``
        (default: the d=5 field sweep)."""
        NP_, ndofp_, K_ = (sw or fused).tabs.shape
        nbytes = B * NP_ * 4 + NP_ * ndofp_ * K_ * 4 + 2 * B * fs.padded_k(K_) * 4
        return max(nbytes / peak_bw, B * K_ * 4 * NP_ / peak_flops) * 1e3

    def stage_ms(samples, sweep, n_out, out_dtype=torch.float32):
        """Device time of the two kernels of a field wiring over the
        wrapper's row chunks, timed apart: all factor-kernel launches, then
        all GEMM launches, beside stage 1's own bound (its F halves written
        once).  The GEMM rereads the last chunk's factors (its time does not
        depend on their values)."""
        B, K_s = samples.shape[0], int(sweep.tabs.shape[2])
        chunks = fs.row_chunks(B, K_s, n_out)
        hi = torch.empty((chunks[0][1], fs.padded_k(K_s)), device=dev)
        lo = torch.empty_like(hi)
        dst = torch.empty((B, n_out), dtype=out_dtype, device=dev)

        def stage1():
            for r0, r1 in chunks:
                fs.factors_stage(samples[r0:r1], sweep.grid, sweep.tabs, sweep.n_modes,
                                 hi[: r1 - r0], lo[: r1 - r0], plan=sweep.plan,
                                 sliced=sweep.sliced)

        maps = sweep.gemm_maps()

        def stage2():
            for r0, r1 in chunks:
                fs.gemm_stage(hi[: r1 - r0], lo[: r1 - r0], *sweep.table, dst[r0:r1], maps=maps)

        return {"factor_stage_ms": cuda_ms(stage1, 3), "gemm_ms": cuda_ms(stage2, 3),
                "factor_stage_bound_ms": stage1_bound(B, sweep), "row_chunks": len(chunks)}

    def kernel_of(sweep, mode):
        """The stage-1 kernel's instance (the factor kernel writing F or its
        split, or the narrow product); its tile and grid for the call are
        the entry's ``plan`` (:func:`plan_of`)."""
        p = sweep.plan
        if mode == "narrow":
            return (f"sweep_narrow_kernel<ks={p.ks}, nt={fs.narrow_nt(int(sweep.m0.shape[1]))}, "
                    f"{p.route}>")
        return f"sweep_factors_kernel<ks={p.ks}, {mode}, {p.route}>"

    def smem_bound(sweep, B):
        """The shared-memory bytes the narrow product's gathers read on
        ``B`` samples (each active slice's columns: deg + 1 table values of
        4 bytes a dim, a sample) and the time they take at 128 bytes a clock
        an SM at the card's highest SM clock (a data-sheet rate, not a
        measurement): informational, beside the HBM bound."""
        deg = [int(d) for d in sweep.grid[3].tolist()]
        cols = -(-sweep.n_modes // sweep.plan.ks) * sweep.plan.ks
        nbytes = B * cols * sum(d + 1 for d in deg) * 4
        rate = fs.sm_count(dev) * 128 * sm_clock_hz
        return {"smem_bytes": nbytes, "bound_smem_ms": nbytes / rate * 1e3}

    def plan_of(sweep, B):
        """What one call of the wiring ``sweep`` on ``B`` samples launched,
        as its launchers report it (``FusedSweep.last_plan``): the factor
        kernel's tile plan and each launch's 2D grid (row tiles x k-ranges,
        ops/fused_sweep.py::factor_grid) and, for the field wiring, each
        GEMM launch's work items and persistent blocks; the partial sums'
        blocks where they ran.  The call is made here on seeded samples
        inside the grid, and its launches are left out of every count."""
        counts = dict(fs.LAUNCHES), dict(fs.STAGE_LAUNCHES), sweep.launches
        gen = torch.Generator(device=dev)
        gen.manual_seed(B)
        lo_p, span = sweep.grid[0], sweep.grid[2] / sweep.grid[1]
        sweep(lo_p + span * torch.rand((B, sweep.grid.shape[1]), generator=gen, device=dev))
        torch.cuda.synchronize()
        fs.LAUNCHES.update(counts[0])
        fs.STAGE_LAUNCHES.update(counts[1])
        sweep.launches = counts[2]
        p = sweep.plan
        return {"factor": {"ks": p.ks, "route": p.route,
                           "launches": sweep.last_plan["factor"]},
                **({"gemm": sweep.last_plan["gemm"]} if "gemm" in sweep.last_plan else {})}

    def entry(name, kernel, wiring, kernel_out_shape, launches_n, worst, ms, plain_ms, lib_ms,
              bound, c, sw=None, **extra):
        if sw is not None:
            extra = {"plan": plan_of(sw, int(kernel_out_shape[0])), **extra}
            if sw.m0_slices is not None:
                extra = {**smem_bound(sw, int(kernel_out_shape[0])), **extra}
        kernels.append({
            "name": name, "kernel": kernel, "route": "cuda",
            "source": "pgdrome_tpu_torch/csrc/fused_sweep.cu",
            "replaces": "pgdrome_tpu/ops/pallas_kernels.py:43",
            "wiring": wiring, "shape": list(kernel_out_shape),
            "launches": launches_n, "max_abs_err": worst["vs_plain"],
            "max_abs_err_vs_f64": worst["vs_f64"], "err_over_bound": worst["ratio"],
            "locate_cells": worst.get("locate_cells", 0.0),
            "gamma_c": c, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": lib_ms,
            "bound_fp32_ms": bound["bound_fp32_ms"], "share": bound["bound_ms"] / ms,
            "flops": bound["flops"], "bytes": bound["bytes"], "clocks_after": clocks(),
            **extra,
        })
        say(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}, f32-pipe bound "
            f"{bound['bound_fp32_ms']:.4f} ms), max|err| vs plain {worst['vs_plain']:.3e}, "
            f"vs f64 {worst['vs_f64']} ({worst['ratio']:.3f} of its bound)"
            + "".join(f", {k} {v}" for k, v in extra.items())
            + f", clocks after (sm, power, temperature): {kernels[-1]['clocks_after']}")

    # ------------------------------------------------------------- fields
    with Phase("check_fields"):
        w_f32 = hold(out, s_fields, m0, c_fields)
        for i, lo in ((0, 0), (n_chunks - 1, (n_chunks - 1) * B_FIELDS)):
            one_shot = vd.fields(s_stream[lo : lo + B_FIELDS])
            check(torch.equal(kept[i], one_shot), f"stream chunk {i} equals one-shot fields bit for bit")
            del one_shot
        del kept
        bf = bf16_blocks.pop()
        check(bf.dtype == torch.bfloat16 and bf.shape == out.shape, "bf16 block shape")
        bf_err = float((bf.double() - out.double()).abs().max())
        out_max = float(out.abs().max())
        say(f"bf16 store: max|bf16 − f32 kernel| {bf_err:.4e} "
            f"(bound {BF16_REL:g} · {out_max:.4e})")
        check(bf_err < BF16_REL * out_max, "bf16 store within its quantization")
        w_bf16 = hold(bf, s_fields, m0, c_fields, out_dtype=torch.bfloat16)
        del bf
        fac_fields = fs.fused_sweep(s_fields, grid, tabs, None, vd.n_modes)
        # the GEMM's operand: the split store is split_factors of the plain
        # factors, bit for bit (the head columns whole, the rest split_tf32),
        # its columns in the sweep's binding of the modes (fs.head_order)
        rows_split = 65_536
        hi = torch.empty((rows_split, fs.padded_k(K)), device=dev)
        lo = torch.empty_like(hi)
        fs.factors_stage(s_fields[:rows_split], grid, tabs, vd.n_modes, hi, lo,
                         plan=fused.plan, sliced=fused.sliced)
        fac_split = fs.fused_sweep_plain(s_fields[:rows_split], grid, tabs, None, vd.n_modes)
        p_hi, p_lo = fs.split_factors(fac_split if fused.order is None
                                      else fac_split[:, fused.order])
        del fac_split
        check(torch.equal(hi[:, :K].view(torch.int32), p_hi.view(torch.int32))
              and torch.equal(lo[:, :K].view(torch.int32), p_lo.view(torch.int32))
              and not bool(hi[:, K:].any()) and not bool(lo[:, K:].any()),
              "split factor store equals split_factors of the plain factors bit for bit")
        del hi, lo, p_hi, p_lo
        ms_f32 = cuda_ms(lambda: fused(s_fields), 3)
        stages_f32 = stage_ms(s_fields, fused, n0)
        fused_bf16 = vd._sweep(torch.bfloat16)
        ms_bf16 = cuda_ms(lambda: fused_bf16(s_fields), 3)
        stages_bf16 = stage_ms(s_fields, fused, n0, torch.bfloat16)
        plain_f32 = cuda_ms(lambda: fs.fused_sweep_plain(s_fields, grid, tabs, m0, vd.n_modes), 2)
        plain_bf16 = cuda_ms(lambda: fs.fused_sweep_plain(s_fields, grid, tabs, m0, vd.n_modes,
                                                          torch.bfloat16), 2)
        lib = cuda_ms(lambda: torch.matmul(fac_fields, m0), 3)
        del fac_fields
        field_kernels = kernel_of(fused, "split") + " + sweep_gemm_kernel"
        entry("fused_sweep_fields_f32", field_kernels + "<f32>",
              "parallel/vademecum.py::make_sweep_fn", out.shape,
              launches["fields_f32"], w_f32, ms_f32, plain_f32, lib,
              roofline(B_FIELDS, n0, 4, True), c_fields, stages=stages_f32, sw=fused)
        entry("fused_sweep_fields_bf16", field_kernels + "<bf16>",
              "parallel/vademecum.py::make_sweep_fn(out_dtype=bf16)",
              out.shape, launches["fields_bf16"], w_bf16, ms_bf16, plain_bf16, lib,
              roofline(B_FIELDS, n0, 2, True), c_fields, stages=stages_bf16, sw=fused_bf16)
        del out

    # ------------------------------------------------------------ sensors
    with Phase("check_sensors"):
        table = vd.sensors(pts).m0
        check(table.shape == (K, N_PTS), "sensor table shape")
        w_sens = hold(resp, s_big, table, c_fields, rows=524_288)
        check(torch.equal(resp_stream, resp.cpu()), "sensors_stream equals one-shot sensors")
        sensor_sweep = vd.sensors(pts)
        ms_sens = cuda_ms(lambda: sensor_sweep(s_big), 3)
        # the fused launch alone, into a preallocated output
        dst = torch.empty((B_BIG, N_PTS), device=dev)
        stages_sens = {"sensor_fused_ms": cuda_ms(lambda: fs._launch_factors(
            s_big, grid, tabs, vd.n_modes, sensor_sweep.plan, sensor_sweep.sliced, dst,
            m0_slices=sensor_sweep.m0_slices), 3)}
        del dst
        plain_sens = cuda_ms(lambda: fs.fused_sweep_plain(s_big, grid, tabs, table, vd.n_modes), 1)
        factor_sweep = fs.FusedSweep(grid, tabs, None, vd.n_modes)
        fac_big = factor_sweep(s_big)
        lib_sens = cuda_ms(lambda: torch.matmul(fac_big, table), 3)
        # the unfused two-step route: the factor wiring writes F to HBM, then
        # one torch.matmul (the yardstick the fused kernel must beat)
        two_step = cuda_ms(lambda: torch.matmul(factor_sweep(s_big), table), 3)
        say(f"sensors: fused {ms_sens:.4f} ms, two-step route (factor wiring + torch.matmul) "
            f"{two_step:.4f} ms, library (torch.matmul on F) {lib_sens:.4f} ms")
        check(torch.equal(factor_sweep(s_big[:65_536]), fac_big[:65_536]),
              "the two-step route's factors are the factor wiring's")
        entry("fused_sweep_sensors", kernel_of(sensor_sweep, "narrow"),
              "parallel/vademecum.py::make_sensor_sweep_fn",
              resp.shape, launches["sensors"], w_sens, ms_sens, plain_sens, lib_sens,
              roofline(B_BIG, N_PTS, 4, True), c_fields, stages=stages_sens, sw=sensor_sweep,
              two_step_ms=two_step)
        del resp, resp_stream

    # ------------------------------------------------------------ moments
    with Phase("check_moments"):
        w_fac = hold(fac_big, s_big, None, c_factors, rows=524_288)
        del fac_big
        torch.cuda.empty_cache()
        ms_fac = cuda_ms(lambda: factor_sweep(s_big), 3)
        plain_fac = cuda_ms(lambda: fs.fused_sweep_plain(s_big, grid, tabs, None, vd.n_modes), 1)
        entry("fused_sweep_factors", kernel_of(factor_sweep, "F"),
              "parallel/vademecum.py::make_factor_moments_fn",
              (B_BIG, K), launches["factors"], w_fac, ms_fac, plain_fac, None,
              roofline(B_BIG, K, 4, False), c_factors, sw=factor_sweep)
        torch.cuda.empty_cache()
        vd_plain = Vademecum(vd.spaces, vd.result, method="torch")
        mean_p, var_p = vd_plain.moments(s_big, chunk=1_048_576)
        d_mean = float((mean - mean_p).abs().max())
        d_var = float((var - var_p).abs().max())
        m_max = float(mean_p.abs().max())
        m2_max = float((var_p + mean_p ** 2).max())  # E[u²]
        var_max = float(var_p.max())
        say(f"moments: max|Δmean| {d_mean:.4e} (bound {MEAN_REL:g} · {m_max:.4e}), "
            f"max|Δvar| {d_var:.4e} (bound {VAR_REL:g} · max E[u²] {m2_max:.4e}), "
            f"max var {var_max:.4e}, max|Δvar| / max var {d_var / var_max:.4e}")
        check(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()), "finite moments")
        check(d_mean <= MEAN_REL * m_max, "kernel-path mean vs plain-path mean")
        check(d_var <= VAR_REL * m2_max, "kernel-path variance vs plain-path variance")

    # ---------------------------------------------------------- analytics
    # the rest of serving on the same d=5 vademecum: save/load, errors,
    # a fixed-parameter slice and the derivative vademecum through the field
    # kernel, the parameter Jacobian, the Gauss–Newton fit, the posterior,
    # exact Sobol' indices and sensor design
    with Phase("analytics"):
        import shutil
        import tempfile

        import numpy as np

        from pgdrome_tpu_torch.fem.derivative import derivative_function
        from pgdrome_tpu_torch.fem.function import Function
        from pgdrome_tpu_torch.fem.interpolate import _cell_widths, _locate_1d
        from pgdrome_tpu_torch.fem.assembly import mass_matrix
        from pgdrome_tpu_torch.parallel.bayes import make_mcmc_fn
        from pgdrome_tpu_torch.parallel.vademecum import sensor_table
        from pgdrome_tpu_torch.uq import _mixed_product

        analytics = {}

        def timed(key, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            analytics[key] = time.perf_counter() - t0
            return out

        # 1. save → load: the reloaded vademecum serves the same fields
        tmp_a = Path(tempfile.mkdtemp(prefix="chip_smoke_analytics_"))
        try:
            timed("save_s", lambda: vd.save(tmp_a / "d5.npz"))
            vd_re = timed("load_s", lambda: Vademecum.load(tmp_a / "d5.npz", vd.spaces,
                                                           device=dev))
            size = (tmp_a / "d5.npz").stat().st_size
        finally:
            shutil.rmtree(tmp_a, ignore_errors=True)
        s_rt = s_fields[:4096]
        check(isinstance(vd_re._sweep(), fs.FusedSweep)
              and torch.equal(vd_re.fields(s_rt), vd.fields(s_rt)),
              "save → load: the reloaded vademecum's kernel fields equal the original's")
        del vd_re
        say(f"analytics save/load: {size / 2**20:.3f} MiB, save {analytics['save_s']:.3f} s, "
            f"load {analytics['load_s']:.3f} s; 4096 kernel fields equal bit for bit")

        # 2. errors at the inset corners against the FEM truth
        err_c = timed("errors_s", lambda: vd.errors(corners, np.stack(u_fem)))
        e_max = float(err_c.max())
        say(f"analytics errors: max rel-L2 {e_max:.9e} over the {len(corners)} inset corners "
            f"(the fem_truth phase's kernel figure {e_kernel:.9e}, |rel| "
            f"{abs(e_max / e_kernel - 1):.3e})")
        check(err_c.is_cuda and err_c.dtype == torch.float64
              and abs(e_max / e_kernel - 1) <= 1e-12,
              "errors() equals the kernel fields' FEM error")

        # 3. a fixed-parameter slice through the field kernel at NP = 3
        vd_fix = vd.fix_parameters(FIXED)
        fused_fix = vd_fix._sweep()
        free = [j for j in range(NUM_PARAMS) if j not in FIXED]
        check(isinstance(fused_fix, fs.FusedSweep) and fused_fix.tabs.shape[0] == 3,
              "the slice takes the kernel at NP = 3")
        s3 = s_fields[:, free].contiguous()
        torch.cuda.synchronize()
        fs.reset_launch_counts()
        out3 = vd_fix.fields(s3)
        torch.cuda.synchronize()
        launches_fix, stages_fix = dict(fs.LAUNCHES), dict(fs.STAGE_LAUNCHES)
        say(f"launches on the fix_parameters path: {json.dumps(launches_fix)}; kernels "
            f"{json.dumps(stages_fix)}")
        check(launches_fix["fields_f32"] == 1 and stages_fix["gemm"] >= 1
              and stages_fix["factors_stage"] == stages_fix["gemm"],
              "the slice's fields ran the field wiring's kernels")
        s5 = s_fields.clone()
        for j, v in FIXED.items():
            s5[:, j] = v
        # held to the full vademecum's f64 plain product with the fixed values
        # inserted: γ_c with c = K + 4·5 covers the slice's K + 4·3 roundings
        # and the one of its folded dim-0 table
        w_fix = hold(out3, s5, m0, c_fields)
        g3, tb3, m03 = fused_fix.grid, fused_fix.tabs, fused_fix.m0
        ms_fix = cuda_ms(lambda: fused_fix(s3), 3)
        plain_fix = cuda_ms(lambda: fs.fused_sweep_plain(s3, g3, tb3, m03, vd.n_modes), 2)
        fac3 = fs.fused_sweep(s3, g3, tb3, None, vd.n_modes)
        lib_fix = cuda_ms(lambda: torch.matmul(fac3, m03), 3)
        del fac3
        entry("fused_sweep_fields_f32_fixed_np3",
              kernel_of(fused_fix, "split") + " + sweep_gemm_kernel<f32>",
              "serving.py::Vademecum.fix_parameters -> parallel/vademecum.py::make_sweep_fn "
              f"(params {sorted(FIXED)} fixed, NP = 3)", out3.shape,
              launches_fix["fields_f32"], w_fix, ms_fix, plain_fix, lib_fix,
              roofline(B_FIELDS, n0, 4, True, sw=fused_fix), c_fields,
              stages=stage_ms(s3, fused_fix, n0), sw=fused_fix)
        del out3, s5

        # 4. the derivative vademecum: DG1 dim-0 table, n0 = 2048
        vd_d = timed("derivative_build_s", vd.derivative)
        fused_d = vd_d._sweep()
        n0_d = int(vd_d._modes[0].shape[1])
        check(isinstance(fused_d, fs.FusedSweep) and n0_d == 2048
              and (vd_d.spaces[0].family, vd_d.spaces[0].degree) == ("DG", 1),
              "the derivative vademecum serves a DG1 table of 2048 dofs through the kernel")
        torch.cuda.synchronize()
        fs.reset_launch_counts()
        out_d = vd_d.fields(s_fields)
        torch.cuda.synchronize()
        launches_d, stages_d = dict(fs.LAUNCHES), dict(fs.STAGE_LAUNCHES)
        say(f"launches on the derivative path: {json.dumps(launches_d)}; kernels "
            f"{json.dumps(stages_d)}")
        check(launches_d["fields_f32"] == 1 and stages_d["gemm"] >= 1
              and stages_d["factors_stage"] == stages_d["gemm"],
              "the derivative fields ran the field wiring's kernels")
        w_d = hold(out_d, s_fields, fused_d.m0, c_fields, sw=fused_d)
        du_fem = np.stack([derivative_function(Function(vd.spaces[0], u)).array for u in u_fem])
        du_served = vd_d.fields(corners).double().cpu().numpy()
        gap_d = np.linalg.norm(du_served - du_fem, axis=1) / np.linalg.norm(du_fem, axis=1)
        say(f"analytics derivative: served du/dx vs derivative_function of the FEM solutions, "
            f"max rel-L2 {gap_d.max():.6e}, median {np.median(gap_d):.6e} over the "
            f"{len(corners)} inset corners (printed, no gate); build "
            f"{analytics['derivative_build_s']:.3f} s")
        gd, tbd, md = fused_d.grid, fused_d.tabs, fused_d.m0
        ms_d = cuda_ms(lambda: fused_d(s_fields), 3)
        plain_d = cuda_ms(lambda: fs.fused_sweep_plain(s_fields, gd, tbd, md, vd.n_modes), 2)
        fac_d = fs.fused_sweep(s_fields, gd, tbd, None, vd.n_modes)
        lib_d = cuda_ms(lambda: torch.matmul(fac_d, md), 3)
        del fac_d
        entry("fused_sweep_fields_f32_derivative_dg1",
              kernel_of(fused_d, "split") + " + sweep_gemm_kernel<f32>",
              "serving.py::Vademecum.derivative -> parallel/vademecum.py::make_sweep_fn "
              "(DG1 dim-0 table, n0 = 2048)", out_d.shape, launches_d["fields_f32"], w_d,
              ms_d, plain_d, lib_d, roofline(B_FIELDS, n0_d, 4, True, sw=fused_d), c_fields,
              stages=stage_ms(s_fields, fused_d, n0_d), sw=fused_d)
        del out_d

        # 5. the parameter Jacobian at 16 sensors, samples inside grid cells
        pts_s = np.linspace(0.03, 0.97, N_SENS)
        gen_a = torch.Generator(device=dev)
        gen_a.manual_seed(SEED + 5)
        cells = torch.randint(0, 128, (B_JAC, NUM_PARAMS), generator=gen_a, device=dev)
        s_jac = (cells + 0.25 + 0.5 * torch.rand((B_JAC, NUM_PARAMS), generator=gen_a,
                                                  device=dev)) / 128
        vd64 = Vademecum(vd.spaces, vd.result, method="torch", dtype=torch.float64, device=dev)
        jac32 = vd.sensors_jacobian(pts_s)
        J32 = timed("jacobian_s", lambda: jac32(s_jac))
        J64 = vd64.sensors_jacobian(pts_s)(s_jac)

        def abs_factors(V, M, p, derivative):
            """Σ_l |φ_l| |T_l| (or Σ_l |φ'_l| |T_l| / h): the absolute
            counterpart of a factor value, in f64."""
            cell, xi = _locate_1d(V.mesh(), p, torch)
            ed = V.element_dofs_device(dev)[cell]
            nodes = M.abs().double().T[ed]  # (B, nl, K)
            if derivative:
                wgt = torch.ones_like(xi)[:, None].expand(-1, 2) / _cell_widths(
                    V.mesh(), cell, xi, torch)[:, None]
            else:
                wgt = torch.stack([1 - xi, xi], -1)
            return torch.einsum("bl,blk->bk", wgt, nodes)

        s64 = s_jac.double()
        va = [abs_factors(vd.spaces[j], vd._modes[j], s64[:, j - 1], False)
              for j in range(1, NUM_PARAMS + 1)]
        da = [abs_factors(vd.spaces[j], vd._modes[j], s64[:, j - 1], True)
              for j in range(1, NUM_PARAMS + 1)]
        t_abs = torch.as_tensor(sensor_table(vd.spaces[0], vd64._modes[0], pts_s),
                                device=dev).abs()
        # c: the factor model's K + 4·NP roundings, one of the f32 sensor
        # table and one of the derivative's division by h
        c_jac = K + 4 * NUM_PARAMS + 2
        worst_j = 0.0
        for j in range(NUM_PARAMS):
            fa = da[j]
            for l in range(NUM_PARAMS):
                if l != j:
                    fa = fa * va[l]
            bound_j = gamma(c_jac) * (fa @ t_abs)
            e_j = (J32[:, :, j].double() - J64[:, :, j]).abs()
            check(bool((e_j <= bound_j).all()), f"Jacobian column {j} within γ_c of the f64 one")
            worst_j = max(worst_j, float((e_j / bound_j.clamp_min(1e-300)).max()))
        del va, da
        rtol, atol, h = JAC_FD
        sens64 = vd64.sensors(pts_s)
        fd_worst = 0.0
        for j in range(NUM_PARAMS):
            dp = torch.zeros(NUM_PARAMS, dtype=torch.float64, device=dev)
            dp[j] = h
            fd = (sens64(s64 + dp) - sens64(s64 - dp)) / (2 * h)
            excess = (J64[:, :, j] - fd).abs() - (atol + rtol * fd.abs())
            fd_worst = max(fd_worst, float(excess.max()))
        say(f"analytics Jacobian: {B_JAC} samples x {N_SENS} sensors x {NUM_PARAMS} params in "
            f"{analytics['jacobian_s']:.4f} s ({B_JAC / analytics['jacobian_s']:.6g} samples/s, "
            f"f32, plain products); vs the f64 Jacobian {worst_j:.3f} of its γ_c bound "
            f"(c = {c_jac}); f64 vs central differences (h {h:g}): worst |Δ| − (atol + rtol|fd|) "
            f"{fd_worst:.3e} (rtol {rtol:g}, atol {atol:g})")
        check(fd_worst <= 0.0, "the f64 Jacobian equals central differences of the f64 sweep")
        del J32, J64, s64

        # 6. the Gauss–Newton fit: 1024 observations x 8 starts, f32 on the card
        rng_a = np.random.default_rng(SEED)
        p_true = rng_a.uniform(0.1, 0.9, size=(B_FIT, NUM_PARAMS))
        obs = vd64.sensors(pts_s)(p_true).cpu().numpy()
        p_hat, resn = timed("fit_s", lambda: vd.fit_parameters(
            pts_s, obs, n_starts=FIT_STARTS, seed=0, n_iter=FIT_ITERS))
        # the same fit of one observation: how the time scales with the batch
        timed("fit_one_s", lambda: vd.fit_parameters(pts_s, obs[:1], n_starts=FIT_STARTS,
                                                      seed=0, n_iter=FIT_ITERS))
        d_p = np.abs(p_hat - p_true)
        smin = np.linalg.svd(vd64.sensors_jacobian(pts_s)(p_true).cpu().numpy(),
                             compute_uv=False)[:, -1]
        nu = float(vd.fit_parameters(pts_s, obs, p0=p_true, n_iter=0)[1].max())
        limit = FIT_NOISE * nu / smin
        e2 = np.linalg.norm(p_hat - p_true, axis=1)
        r64 = np.linalg.norm(vd64.sensors(pts_s)(p_hat.astype(np.float64)).cpu().numpy() - obs,
                             axis=1)
        ratio = e2 / (r64 / smin)
        say(f"analytics fit: {B_FIT} observations x {FIT_STARTS} starts ({B_FIT * FIT_STARTS} "
            f"problems), {FIT_ITERS} iterations, f32: {analytics['fit_s']:.3f} s "
            f"({B_FIT / analytics['fit_s']:.6g} observations/s; one observation "
            f"{analytics['fit_one_s']:.3f} s); max |p̂ − p| {d_p.max():.3e}, "
            f"median {np.median(d_p):.3e}; resnorm max {resn.max():.3e}, median "
            f"{np.median(resn):.3e} (ν at the truth {nu:.3e}; max |obs| "
            f"{np.abs(obs).max():.4e}); σ_min(J) {smin.min():.3e}..{smin.max():.3e}; "
            f"‖p̂ − p‖₂ / ({FIT_NOISE}ν/σ_min) max {(e2 / limit).max():.4f}, median "
            f"{np.median(e2 / limit):.4f}; diagnostic ‖p̂ − p‖ / (‖s64(p̂) − obs‖ / σ_min) max "
            f"{ratio.max():.3f}, median {np.median(ratio):.3f}")
        check(bool(np.isfinite(p_hat).all() and (smin > 0).all() and nu > 0),
              "finite fit, full-rank J")
        check(float(resn.max()) <= nu, "the fit's resnorm within the f32 residual at the truth")
        check(bool((e2 <= limit).all()), f"the f32 fit recovers the parameters to "
              f"{FIT_NOISE}ν/σ_min(J)")

        # 7. the posterior of one observation
        sig = POST_SIGMA * np.abs(obs[0]).max()
        # the posterior's MAP fit alone, as sample_posterior calls it (the
        # fit's first call, its set-up included; the posterior reuses it)
        timed("map_fit_s", lambda: vd.fit_parameters(pts_s, obs[:1],
                                                     weights=np.full(N_SENS, 1 / sig),
                                                     n_starts=8, seed=0))
        post = timed("posterior_s", lambda: vd.sample_posterior(
            pts_s, obs[0], sig, n_samples=POST_SAMPLES, n_chains=POST_CHAINS, seed=0))
        # the chain steps alone: one run of the sampler from the posterior's
        # last state with its tuned proposal
        mcmc = make_mcmc_fn(vd.spaces, vd._modes, vd.n_modes, pts_s, n_steps=MCMC_STEPS)
        gen_m = torch.Generator(device=dev)
        gen_m.manual_seed(SEED + 7)
        _, n_acc_m = timed("mcmc_s", lambda: mcmc(
            obs[0], np.full(N_SENS, sig), post["chains"][-1], post["proposal_chol"],
            post["proposal_scale"], generator=gen_m))
        lo_q, hi_q = np.quantile(post["samples"], [0.0005, 0.9995], axis=0)
        inside = (p_true[0] >= lo_q) & (p_true[0] <= hi_q)
        say(f"analytics posterior: {POST_CHAINS} chains x {POST_SAMPLES} kept steps "
            f"(σ {sig:.4e}): {analytics['posterior_s']:.3f} s (after its MAP fit's first call, "
            f"{analytics['map_fit_s']:.3f} s); the sampler alone {MCMC_STEPS} steps in "
            f"{analytics['mcmc_s']:.3f} s, {MCMC_STEPS / analytics['mcmc_s']:.1f} steps/s "
            f"({MCMC_STEPS * POST_CHAINS / analytics['mcmc_s']:.6g} chain steps/s, acceptance "
            f"{float(n_acc_m.double().mean()) / MCMC_STEPS:.4f}); r_hat "
            f"{np.round(post['r_hat'], 4).tolist()}, acceptance {post['acceptance']:.4f}, "
            f"ess {np.round(post['ess'], 1).tolist()}; true p in the 99.9 % intervals "
            f"{inside.tolist()}")
        check(bool((post["r_hat"] <= 1.05).all()), "posterior r_hat <= 1.05")
        check(0.1 <= post["acceptance"] <= 0.6, "posterior acceptance in [0.1, 0.6]")
        check(bool(inside.all()), "the true parameters inside each marginal's 99.9 % interval")

        # 8. exact Sobol' indices, aggregated and at the sensors
        sob = timed("sobol_s", lambda: vd.sobol(second_order=True))
        sob_p = timed("sobol_points_s", lambda: vd.sobol(pts_s, second_order=True))
        mean_c, cov_c = vd.output_covariance(pts_s)
        check(float(sob["first"].sum()) <= 1 + 1e-9 and bool((sob_p["first"].sum(0)
                                                             <= 1 + 1e-9).all()),
              "Σ first-order indices <= 1")
        check(bool((sob["total"] >= sob["first"] - 1e-12).all()
                   and (sob_p["total"] >= sob_p["first"] - 1e-12).all()),
              "total indices >= first-order ones")
        check(bool((np.abs(np.diag(cov_c) - sob_p["variance"])
                    <= 1e-12 * np.abs(sob_p["variance"])).all()),
              "output_covariance's diagonal is the per-output variance")
        # the Monte-Carlo check: the serving phase's moments over s_big
        # (var_mc) weighted by the lumped masses w = 1ᵀW against the exact
        # lumped value, Σ w_i Var_exact(u_i) / vol, within MC_SIGMAS standard
        # errors (per-sample g_b = (f_b − f̄)ᵀ M0 diag(w) M0ᵀ (f_b − f̄) / vol
        # over the kernel's factors, in f64) plus the device f32 reduction's
        # allowance of the serving phase (VAR_REL of the lumped E[u²]); the
        # aggregated Sobol' variance integrates the same variance with the
        # consistent mass: its gap to the lumped value is printed
        V0 = vd.spaces[0]
        vol = float(np.sum(V0.q_weights))
        w_l = mass_matrix(V0).sum(axis=0)
        M0h = vd._modes[0].double().cpu().numpy()
        stats = vd._factor_stats()
        Pm = np.prod([m for m, _ in stats], axis=0)
        Kc = _mixed_product(stats, range(NUM_PARAMS)) - np.outer(Pm, Pm)
        var_exact = np.einsum("ki,ki->i", Kc @ M0h, M0h)
        V_lump = float(w_l @ var_exact) / vol
        V_mc = float(w_l @ var.numpy()) / vol
        E2_lump = float(w_l @ (var.numpy() + mean.numpy() ** 2)) / vol
        G_w = torch.as_tensor((M0h * w_l) @ M0h.T / vol, device=dev)
        fac_fn = fs.FusedSweep(grid, tabs, None, vd.n_modes)
        fbar = None
        g_sum = g_sq = 0.0
        for pass_ in (0, 1):
            acc = torch.zeros(K, dtype=torch.float64, device=dev)
            for r0 in range(0, B_BIG, B_FIELDS):
                f = fac_fn(s_big[r0 : r0 + B_FIELDS]).double()[:, : vd.n_modes]
                if pass_ == 0:
                    acc += f.sum(0)
                    continue
                fc = f - fbar
                g = ((fc @ G_w) * fc).sum(1)
                g_sum += float(g.sum())
                g_sq += float((g * g).sum())
            if pass_ == 0:
                fbar = acc / B_BIG
        g_mean = g_sum / B_BIG
        se = (max(g_sq / B_BIG - g_mean ** 2, 0.0) / B_BIG) ** 0.5
        tol_mc = MC_SIGMAS * se + VAR_REL * E2_lump + abs(V_lump - float(sob["variance"]))
        say(f"analytics sobol: aggregated variance {float(sob['variance']):.9e}, first "
            f"{np.round(sob['first'], 6).tolist()}, total {np.round(sob['total'], 6).tolist()}, "
            f"Σ first {float(sob['first'].sum()):.9f}; at {N_SENS} sensors Σ first max "
            f"{float(sob_p['first'].sum(0).max()):.9f}; {analytics['sobol_s']:.3f} s + "
            f"{analytics['sobol_points_s']:.3f} s (host f64)")
        say(f"analytics sobol vs Monte Carlo ({B_BIG} samples): lumped exact {V_lump:.9e} "
            f"(consistent-mass Sobol' gap {V_lump - float(sob['variance']):+.3e}); moments' "
            f"lumped {V_mc:.9e} (|Δ| {abs(V_mc - V_lump):.3e}); f64 mean of g_b {g_mean:.9e} "
            f"(|Δ| {abs(g_mean - V_lump):.3e}), standard error {se:.3e}; bound {tol_mc:.3e} "
            f"({MC_SIGMAS} SE + {VAR_REL:g} E[u²] + the quadrature gap)")
        check(abs(g_mean - V_lump) <= MC_SIGMAS * se, "f64 Monte-Carlo variance vs exact")
        check(abs(V_mc - float(sob["variance"])) <= tol_mc,
              "the moments' Monte-Carlo variance agrees with the exact aggregated variance")

        # 9. D-optimal sensor design
        cands = np.linspace(0.01, 0.99, N_CANDIDATES)
        idx_s, pts_d = timed("design_s", lambda: vd.design_sensors(cands, N_DESIGN))
        Jc = vd64.sensors_jacobian(pts_d)(np.full((1, NUM_PARAMS), 0.5)).cpu().numpy()[0]
        det = float(np.linalg.det(Jc.T @ Jc))
        say(f"analytics design: {N_DESIGN} of {N_CANDIDATES} candidates in "
            f"{analytics['design_s']:.3f} s: indices {idx_s.tolist()}, points "
            f"{np.round(pts_d, 4).tolist()}, det(JᵀJ) at the box centre {det:.6e}")
        check(len(set(idx_s.tolist())) == N_DESIGN and det > 0, "design picks 8 distinct sensors")
        say(f"analytics seconds: {json.dumps({k: round(v, 4) for k, v in analytics.items()})}")
        del vd64, vd_d, vd_fix

    # -------------------------------------------------------------- train
    # the training half of the main path: the port alone trains the bench
    # vademecum (host f64 build, f32 enrichment on the card, two f64
    # residual restarts, host compression and Galerkin update), verifies it
    # densely against per-sample FEM, then serves it through the kernel
    with Phase("train"):
        import numpy as np

        from pgdrome_tpu_torch.models.problems import (elliptic_dense_verifier,
                                                       parametric_elliptic)
        from pgdrome_tpu_torch.separated import (PGDResult, SeparatedPGD, combine_results,
                                                 compress_modes, galerkin_update,
                                                 pad_rhs_bucket, precondition_dim0,
                                                 residual_problem)

        torch.cuda.synchronize()
        fs.reset_launch_counts()
        t0 = time.perf_counter()
        sep64, Vs = parametric_elliptic(**TRAIN_BUILD)
        sep_pc, tf = precondition_dim0(sep64, np.float64)
        del sep64
        say(f"train build: {time.perf_counter() - t0:.3f} s (host f64), sizes "
            f"{list(sep_pc.sizes)}, T={sep_pc.num_terms}")
        check(tuple(sep_pc.sizes) == (2047, 129, 129, 129) and sep_pc.num_terms == 4,
              "bench widths")
        res = None
        for si, budget in enumerate(TRAIN_BUDGETS, start=1):
            t0 = time.perf_counter()
            if res is None:
                prob, s_res, fp_kw = sep_pc, None, dict(tol_fp=1e-7, max_fp_it=40)
            else:
                prob, s_res = residual_problem(sep_pc, res)
                prob = pad_rhs_bucket(prob, RHS_BUCKET)
                fp_kw = dict(tol_fp=1e-5, max_fp_it=8)
            t_resid = time.perf_counter() - t0
            t0 = time.perf_counter()
            solver = SeparatedPGD(prob, n_max=budget, tol=0.0, solver="cg", cg_iters=25,
                                  residual_check=False, dtype=np.float32, device=dev, **fp_kw)
            torch.cuda.synchronize()
            t_upload = time.perf_counter() - t0
            t0 = time.perf_counter()
            delta = solver.solve_fused()
            torch.cuda.synchronize()
            t_solve = time.perf_counter() - t0
            del solver
            fp = np.asarray(delta.fp_its)
            say(f"train stage {si}: {t_solve:.3f} s solve ({t_upload:.3f} s upload, "
                f"{t_resid:.3f} s residual build), {delta.n_modes} modes, rhs rows "
                f"{prob.num_rhs}, fp sweeps mean {fp.mean():.2f} max {fp.max()} total "
                f"{fp.sum()}, {fp.sum() / t_solve:.1f} fp sweeps/s, "
                f"{t_solve / fp.sum() * 1e3:.2f} ms/sweep, final rel amplitude "
                f"{delta.amplitudes[-1]:.3e}" + ("" if s_res is None else f", s_res {s_res:.6e}"))
            check(delta.n_modes == budget and np.isfinite(delta.amplitudes).all(),
                  f"stage {si} kept its {budget} modes")
            check(delta.modes[0].is_cuda and delta.modes[0].dtype == torch.float32,
                  "the enrichment ran in f32 on the card")
            res = delta if res is None else combine_results(res, delta, s_res)
        t0 = time.perf_counter()
        n_solved = res.n_modes
        mass_c = [sep_pc.mass[0]] + [sep_pc.ops[j][0] for j in range(1, sep_pc.num_dims)]
        res = compress_modes(res, mass_c, TRAIN_DEPLOY, n_iters=20)
        res = galerkin_update(sep_pc, res)
        say(f"train post-process (compress {n_solved} -> {res.n_modes}, Galerkin): "
            f"{time.perf_counter() - t0:.3f} s")
        check(n_solved == sum(TRAIN_BUDGETS) and res.n_modes == TRAIN_DEPLOY, "trained ranks")

        t0 = time.perf_counter()
        verify = elliptic_dense_verifier(Vs, tf, **VERIFY)
        v = verify(res)
        t_verify = time.perf_counter() - t0
        per = {str(k): float(verify.sample_errors(res, p).max())
               for k, p in verify.samples.items()}
        pts_t = np.concatenate(list(verify.samples.values()))
        say(f"train verify: {t_verify:.3f} s, f64 reconstruction max rel-L2 vs FEM "
            f"{v['max']:.6e} (corners+edges {v['corners']:.6e}, interior "
            f"{v['interior']:.6e}; bound {FEM_BOUND:g}) over {len(pts_t)} samples; "
            f"per group {json.dumps(per)}; the JAX reference {REF_FEM:g} (TPU)")
        check(len(pts_t) == 8 + 3 * 80, "the verification set")
        check(abs(max(per.values()) - v["max"]) <= 1e-12 * v["max"], "per-group maxima")
        check(v["max"] < FEM_BOUND, "trained f64 reconstruction vs FEM")

        vd_t = Vademecum(Vs, res, dim0_transform=tf, method="fused", device=dev)
        fused_t = vd_t._sweep()
        check(isinstance(fused_t, fs.FusedSweep), "the trained vademecum took the kernel")
        s_train = torch.as_tensor(pts_t, dtype=torch.float32, device=dev)
        served_t = vd_t.fields(s_train)
        torch.cuda.synchronize()
        launches_t = dict(fs.LAUNCHES)
        stage_launches_t = dict(fs.STAGE_LAUNCHES)
        say(f"launches on the train path: {json.dumps(launches_t)}; kernels "
            f"{json.dumps(stage_launches_t)}")
        check(launches_t["fields_f32"] == 1 and stage_launches_t["gemm"] >= 1
              and stage_launches_t["factors_stage"] == stage_launches_t["gemm"],
              "the trained vademecum's fields ran the field wiring's kernels")
        fem_t = elliptic_fem_solver(Vs[0], TRAIN_BUILD["num_params"])
        u_t = np.stack([fem_t(p) for p in pts_t])

        def rel_rows(fields, u):
            """Max relative L2 error of (B, n0) fields against FEM rows."""
            f = fields.double().cpu().numpy()
            return float((np.linalg.norm(f - u, axis=1) / np.linalg.norm(u, axis=1)).max())

        e_served = rel_rows(served_t, u_t)
        g, tb, m0_t, n_t = fused_t.grid, fused_t.tabs, fused_t.m0, fused_t.n_modes
        c_t = int(tb.shape[2]) + 4 * int(tb.shape[0])
        w_t = hold(served_t, s_train, m0_t, c_t, sw=fused_t)
        # where the served fields' gap to the f64 reconstruction comes from:
        # the f32 tables alone (their exact product) and the plain f32 path
        e_tables = rel_rows(fs.fused_sweep_plain(s_train, g, tb.double(), m0_t.double(), n_t),
                            u_t)
        e_plain = rel_rows(fs.fused_sweep_plain(s_train, g, tb, m0_t, n_t), u_t)
        say(f"train served: kernel f32 fields max rel-L2 vs FEM {e_served:.6e} "
            f"(bound {FEM_BOUND:g}); f64 product of the f32 tables {e_tables:.6e}, "
            f"plain f32 {e_plain:.6e}, f64 reconstruction {v['max']:.6e}")
        check(e_served < FEM_BOUND, "kernel-served trained fields vs FEM")
        ms_t = cuda_ms(lambda: fused_t(s_train), 20)
        plain_t = cuda_ms(lambda: fs.fused_sweep_plain(s_train, g, tb, m0_t, n_t), 20)
        fac_t = fs.fused_sweep(s_train, g, tb, None, n_t)
        lib_t = cuda_ms(lambda: torch.matmul(fac_t, m0_t), 20)
        entry("fused_sweep_fields_f32_trained",
              kernel_of(fused_t, "split") + " + sweep_gemm_kernel<f32>",
              "parallel/vademecum.py::make_sweep_fn (trained rank-50 bench vademecum)",
              served_t.shape, launches_t["fields_f32"], w_t, ms_t, plain_t, lib_t,
              roofline(len(pts_t), int(m0_t.shape[1]), 4, True, sw=fused_t), c_t,
              factor_stage_bound_ms=stage1_bound(len(pts_t), fused_t), sw=fused_t,
              host=host_split(lambda: fused_t(s_train)))

    # --------------------------------------------- the frontier's serving
    def serve_trained(name, wiring, vd_t, pts, ref_max, slack=None, fem_bound=None,
                      truth=None, plain_slack=None):
        """Serve the trained vademecum ``vd_t`` at ``pts`` through the field
        wiring (the counts were reset at the start of its path): both
        kernels ran, the fields sit within γ_c of the plain version and,
        given a ``slack``, within ``slack`` × ``ref_max`` (the f64
        reconstruction's FEM max there) of FEM and, given a ``plain_slack``,
        within that many times the plain f32 version's FEM error; their FEM
        error is printed beside the plain f32 version's and the f64
        product of the f32 tables'.  ``truth(p)``: the per-sample truth (default the elliptic
        FEM solve).  Timed beside the plain version and the library
        product.  Returns the served fields' FEM error."""
        fused_t = vd_t._sweep()
        check(isinstance(fused_t, fs.FusedSweep), f"{name}: the vademecum took the kernel")
        s_t = torch.as_tensor(pts, dtype=torch.float32, device=dev)
        served_t = vd_t.fields(s_t)
        torch.cuda.synchronize()
        launches_t, stage_launches_t = dict(fs.LAUNCHES), dict(fs.STAGE_LAUNCHES)
        say(f"launches on the {name} path: {json.dumps(launches_t)}; kernels "
            f"{json.dumps(stage_launches_t)}")
        chunked = fs.k_chunks(int(fused_t.tabs.shape[2])) > 1
        check(launches_t["fields_f32"] == 1 and stage_launches_t["gemm"] >= 1
              and stage_launches_t["factors_stage"] == stage_launches_t["gemm"]
              and stage_launches_t["partial_sum"] == (stage_launches_t["gemm"] if chunked else 0),
              f"{name}: the fields ran the field wiring's kernels")
        fem_t = truth or elliptic_fem_solver(vd_t.spaces[0], len(vd_t.spaces) - 1)
        u_t = np.stack([fem_t(p) for p in pts])
        e_served_t = rel_rows(served_t, u_t)
        g, tb, m0_t, n_t = fused_t.grid, fused_t.tabs, fused_t.m0, fused_t.n_modes
        c_t = fs.sum_roundings(int(tb.shape[2])) + 4 * int(tb.shape[0])
        w_t = hold(served_t, s_t, m0_t, c_t, sw=fused_t)
        e_tables = rel_rows(fs.fused_sweep_plain(s_t, g, tb.double(), m0_t.double(), n_t), u_t)
        e_plain = rel_rows(fs.fused_sweep_plain(s_t, g, tb, m0_t, n_t), u_t)
        say(f"{name} served: kernel f32 fields max rel-L2 vs FEM {e_served_t:.6e} over "
            f"{len(pts)} samples; plain f32 {e_plain:.6e}, f64 product of the f32 tables "
            f"{e_tables:.6e}, the f64 reconstruction {ref_max:.6e}; kernel gap "
            f"{e_served_t - ref_max:+.3e}; k summed in {fs.k_chunks(int(tb.shape[2]))} "
            f"chunk(s), c = {c_t}"
            + ("" if slack is None else f" (bound {slack:g} x the f64 reconstruction's)")
            + ("" if plain_slack is None else f" (kernel / plain f32 {e_served_t / e_plain:.4f}, "
               f"bound {plain_slack:g})")
            + ("" if fem_bound is None else f" (kernel and plain bound {fem_bound:g})"))
        if slack is not None:
            check(e_served_t <= slack * ref_max, f"{name}: kernel-served fields vs FEM")
        if plain_slack is not None:
            check(e_served_t <= plain_slack * e_plain,
                  f"{name}: kernel-served fields vs FEM, against the plain f32 version's")
        if fem_bound is not None:
            check(e_served_t < fem_bound and e_plain < fem_bound,
                  f"{name}: kernel and plain f32 fields vs FEM")
        ms_t = cuda_ms(lambda: fused_t(s_t), 20)
        plain_t = cuda_ms(lambda: fs.fused_sweep_plain(s_t, g, tb, m0_t, n_t), 20)
        fac_t = fs.fused_sweep(s_t, g, tb, None, n_t)
        lib_t = cuda_ms(lambda: torch.matmul(fac_t, m0_t), 20)
        entry(name, kernel_of(fused_t, "split") + " + sweep_gemm_kernel<f32>"
              + (" + partial_sum_kernel<f32>" if chunked else ""), wiring,
              served_t.shape, launches_t["fields_f32"], w_t, ms_t, plain_t, lib_t,
              roofline(len(pts), int(m0_t.shape[1]), 4, True, sw=fused_t), c_t,
              stages=stage_ms(s_t, fused_t, int(m0_t.shape[1])), sw=fused_t,
              host=host_split(lambda: fused_t(s_t)))
        if chunked:
            partial_sum_entry(name, fused_t, s_t, stage_launches_t["partial_sum"])
        return e_served_t

    def partial_sum_entry(name, sweep, samples, launches_n):
        """The f64 sum of the GEMM's k-chunk partials for the field wiring
        ``name`` on its own: the partials of ``samples`` made by the GEMM,
        the kernel held bit for bit against the same sum in plain PyTorch
        (f64, chunk order, one rounding to f32) and within one f32
        rounding of that f64 sum, and timed beside it."""
        B, K_s = samples.shape[0], int(sweep.tabs.shape[2])
        Kp, n0_s = fs.padded_k(K_s), int(sweep.m0.shape[1])
        n_ch = fs.k_chunks(Kp)
        hi = torch.empty((B, Kp), device=dev)
        lo = torch.empty_like(hi)
        fs.factors_stage(samples, sweep.grid, sweep.tabs, sweep.n_modes, hi, lo,
                         plan=sweep.plan, sliced=sweep.sliced)
        part = torch.empty((n_ch, B, n0_s), device=dev)
        out_p = torch.empty((B, n0_s), device=dev)
        fs.gemm_stage(hi, lo, *sweep.table, out_p, maps=sweep.gemm_maps(), part=part)

        def f64_sum():
            acc = part[0].double()
            for c in range(1, n_ch):
                acc += part[c].double()
            return acc

        def plain_sum():
            return f64_sum().float()

        blocks = fs.partial_sum(part, out_p)
        e_plain = float((out_p.double() - plain_sum().double()).abs().max())
        check(e_plain == 0.0 and torch.equal(out_p, plain_sum()),
              "the partial sum equals its plain version")
        # the kernel's only f32 rounding is the last: |out − s| ≤ u·|s| for
        # the f64 sum s (u = 2⁻²⁴), 2⁻¹⁵⁰ below the normal range
        s64 = f64_sum()
        e64 = (out_p.double() - s64).abs()
        ratio = float((e64 / torch.clamp(U32 * s64.abs(), min=2.0 ** -150)).max())
        check(ratio <= 1.0, "the partial sum within one f32 rounding of its f64 sum")
        worst = {"vs_plain": e_plain, "vs_f64": float(e64.max()), "ratio": ratio}
        del s64, e64
        ms_p = cuda_ms(lambda: fs.partial_sum(part, out_p), 20)
        plain_p = cuda_ms(plain_sum, 20)
        lib_p = cuda_ms(lambda: torch.sum(part, 0, dtype=torch.float64), 20)
        nbytes = (n_ch + 1) * B * n0_s * 4
        t_bytes = nbytes / peak_bw * 1e3
        t_ops = n_ch * B * n0_s / PEAK_F64 * 1e3
        entry(name.replace("fields_f32", "partial_sum"), "partial_sum_kernel<f32>",
              "ops/fused_sweep.py::partial_sum (the GEMM's k-chunk partials of " + name + ")",
              out_p.shape, launches_n, worst, ms_p, plain_p, lib_p,
              {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
               else "operations", "bound_fp32_ms": max(t_bytes, t_ops),
               "flops": n_ch * B * n0_s, "bytes": nbytes}, 1,
              chunks=n_ch, bit_for_bit=True,
              plan={"partial_sum": {"blocks": blocks, "threads": 256, "chunks": n_ch}},
              host=host_split(lambda: fs.partial_sum(part, out_p)))

    def stage_lines(label, hist, rows):
        """One line per cascade stage: rank, errors, flags, seconds, sweeps."""
        for h, row in zip(hist, rows):
            fp = np.asarray(row["fp_its"])
            sweeps = (f"fp sweeps mean {fp.mean():.2f} max {fp.max()} total {fp.sum()}, "
                      f"{fp.sum() / row['solve_s']:.1f} fp sweeps/s, "
                      f"{row['solve_s'] / fp.sum() * 1e3:.2f} ms/sweep"
                      if fp.size else "no solve (the given start, verified)")
            say(f"{label} stage {int(h['stage'])}: rank {int(h['rank'])}, corners "
                f"{h['corners']:.6e}, interior {h['interior']:.6e}, (boosted, seeded, rhs_comp) "
                f"{tuple(bool(h[f]) for f in ('boosted', 'seeded', 'rhs_comp'))}, stage "
                f"{h['stage_s']:.2f} s, solve {row.get('solve_s', 0.0):.3f} s, {sweeps}, "
                f"residual build {row.get('residual_s', 0.0):.3f} s (rhs rows "
                f"{row.get('rhs_rows', '-')}), Galerkin {row['galerkin_s']:.3f} s, "
                f"verification {row['verify_s']:.3f} s")

    def flags_of(hist):
        return [tuple(bool(h[f]) for f in ("boosted", "seeded", "rhs_comp")) for h in hist]

    def dd_card_vs_cpu(label, rhs):
        """The dd rhs contraction (``_contract_rhs`` of the double-f32
        stacks made from the host f64 ``rhs``, seeded f32 factors) on the
        card against the CPU, bit for bit in every dim; printed beside each
        dim's rel-L2 gap to the f64 contraction, dd and plain f32."""
        rng_f = np.random.default_rng(SEED)
        Fs = [rng_f.uniform(-1.0, 1.0, size=r.shape[1]).astype(np.float32) for r in rhs]
        dd_cpu = [torch.from_numpy(ddf32.dd_from_f64(r)) for r in rhs]
        dd_gpu = [r.to(dev) for r in dd_cpu]
        F_cpu = [torch.from_numpy(f) for f in Fs]
        F_gpu = [f.to(dev) for f in F_cpu]
        r64 = [torch.from_numpy(np.asarray(r, dtype=np.float64)) for r in rhs]
        r32 = [r.float() for r in r64]
        w_gpu, w_cpu = _DDWeights(dd_gpu), _DDWeights(dd_cpu)
        errs = []
        for k in range(len(Fs)):
            b_gpu = _contract_rhs(dd_gpu, F_gpu, k, len(Fs), w_gpu)
            b_cpu = _contract_rhs(dd_cpu, F_cpu, k, len(Fs), w_cpu)
            check(b_gpu.is_cuda and torch.equal(b_gpu.cpu().view(torch.int32),
                                                 b_cpu.view(torch.int32)),
                  f"{label} dim {k}: the dd contraction on the card equals the CPU's bit for bit")
            b64 = _contract_rhs(r64, F_cpu, k, len(Fs))
            b32 = _contract_rhs(r32, F_cpu, k, len(Fs))
            n64 = float(b64.norm())
            errs.append((float((b_cpu.double() - b64).norm()) / n64,
                         float((b32.double() - b64).norm()) / n64))
        say(f"{label} dd contraction ({rhs[0].shape[0]} x {[r.shape[1] for r in rhs]} stack, "
            f"seeded factors): card equals CPU bit for bit in all {len(Fs)} dims; rel-L2 vs "
            f"f64 per dim, dd {[f'{e[0]:.3e}' for e in errs]}, plain f32 "
            f"{[f'{e[1]:.3e}' for e in errs]}")

    import os
    import shutil
    import tempfile

    from pgdrome_tpu_torch.convert import load_state_npz
    from pgdrome_tpu_torch.ops import ddf32
    from pgdrome_tpu_torch.recipes import (frontier_setup, frontier_spaces, highd_frontier,
                                           screened_final, screened_verification)
    from pgdrome_tpu_torch.separated import _contract_rhs, _DDWeights, host_f64
    from pgdrome_tpu_torch.utils.profiling import StageMetrics

    # phases frontier and anova share one setup cache in a temp dir: the
    # frontier phase builds both d=5 problems into it (misses), and both
    # recipes load them (hits); the ANOVA init child puts its init there
    cache_env = os.environ.get("PGDROME_SETUP_CACHE")
    os.environ["PGDROME_SETUP_CACHE"] = str(tmp / "setup_cache")
    try:
        # ------------------------------------------------------- frontier
        # the frontier's training path, cut to its first stage: the port's
        # highd_frontier(5) solves 128 plain f32 modes, verifies them against
        # per-sample f64 FEM, and the result is served through the field
        # kernels
        with Phase("frontier"):
            t0 = time.perf_counter()
            builds = []
            for boost in (FRONTIER["base_boost"], FRONTIER["window_boost"]):
                build, status = frontier_setup(NUM_PARAMS, boost)
                check(status == "miss", f"the phase's build (boost {boost}) fills the cache")
                builds.append(build)
            (sep_base, tf_f), (sep_boost, _) = builds
            Vs_f = frontier_spaces(NUM_PARAMS)
            say(f"frontier build: {time.perf_counter() - t0:.3f} s (host f64, both "
                f"measures, stored in the setup cache), sizes {list(sep_base.sizes)}, "
                f"T={sep_base.num_terms}, R={sep_base.num_rhs}")
            check(tuple(sep_base.sizes) == (2047,) + (129,) * NUM_PARAMS
                  and sep_base.num_terms == NUM_PARAMS + 1
                  and sep_boost.sizes == sep_base.sizes,
                  "the d=5 frontier build: 2047 x 129^5, T = 6")

            torch.cuda.synchronize()
            fs.reset_launch_counts()
            metrics = StageMetrics(dev)
            lines = []

            def log_f(*a):
                lines.append(" ".join(map(str, a)))
                say(*a)

            t0 = time.perf_counter()
            best, report = highd_frontier(
                NUM_PARAMS, max_stages=FRONTIER["max_stages"],
                artifact_path=str(tmp / "frontier_d5_torch.json"), log=log_f,
                metrics=metrics, device=dev)
            t_frontier = time.perf_counter() - t0
            check(sum(ln.startswith("setup cache hit") for ln in lines) == 2,
                  "the recipe loaded both builds from the phase's setup cache")
            hist = report["history"]
            say(f"frontier: {t_frontier:.3f} s for {len(hist)} stage, rank {report['rank']}, "
                f"verified max {report['verified']['max']:.6e} "
                f"(corners {report['verified']['corners_fem_max']:.6e} over "
                f"{report['verified']['corners_fem_n']}, interior "
                f"{report['verified']['interior_fem_max']:.6e}); the JAX record at rank 128 "
                f"(TPU): {FRONTIER_REF:.6e}")
            stage_lines("frontier", hist, metrics.rows)
            check([int(h["rank"]) for h in hist] == [128], "frontier rank 128")
            check(flags_of(hist) == [(False, False, False)], "stage 1 plain f32")
            check(hist[0]["max"] <= 2 * FRONTIER_REF,
                  "rank 128: verified max within 2x the JAX record")
            check(report["verified"]["max"] == hist[0]["max"] and best.n_modes == 128,
                  "the best result is stage 1's")

            verify_f = elliptic_dense_verifier(Vs_f, tf_f, n_random=16,
                                               seeds=(7, 101, 1234, 777), n_edge=16)
            pts_f = np.concatenate(list(verify_f.samples.values()))
            check(len(pts_f) == 32 + 4 * 32, "the 32 inset corners and the verifier's samples")
            serve_trained("fused_sweep_fields_f32_frontier",
                          "parallel/vademecum.py::make_sweep_fn (frontier-trained rank-128 "
                          "d=5 vademecum)",
                          Vademecum(Vs_f, best, dim0_transform=tf_f, method="fused", device=dev),
                          pts_f, report["verified"]["max"], FRONTIER_SERVE_SLACK)

        # ---------------------------------------------------------- anova
        # the frontier from its anchored-ANOVA start: the host f64 init
        # (rank 93), stage 1 verifying it, then one boosted, corner-seeded
        # dd stage of 16 modes; the checkpoint, the dd contraction on the
        # card and the served result are checked
        with Phase("anova"):
            torch.cuda.synchronize()
            fs.reset_launch_counts()
            metrics_a = StageMetrics(dev)
            lines_a = []

            def log_a(*a):
                lines_a.append(" ".join(map(str, a)))
                say(*a)

            t0 = time.perf_counter()
            rc_child = anova_child.wait(timeout=ANOVA_CHILD_WAIT_S)
            t_wait = time.perf_counter() - t0
            for ln in anova_log.read_text().splitlines():
                say(f"[anova init child] {ln}")
            say(f"anova init child: exit {rc_child}, waited for {t_wait:.3f} s")
            check(rc_child == 0, "the ANOVA init child built the init into the setup cache")
            state_a = tmp / "frontier_anova_d5_torch_state.npz"
            t0 = time.perf_counter()
            best_a, rep_a = highd_frontier(
                NUM_PARAMS, anova_order=2, stage_budget=ANOVA["stage_budget"],
                max_stages=ANOVA["max_stages"], state_path=str(state_a),
                artifact_path=str(tmp / "frontier_anova_d5_torch.json"), log=log_a,
                metrics=metrics_a, device=dev)
            t_anova = time.perf_counter() - t0
            check(sum(ln.startswith("setup cache hit") for ln in lines_a) == 2,
                  "the recipe loaded both d=5 builds from the setup cache")
            check(sum(ln.startswith("anova init cache hit") for ln in lines_a) == 1,
                  "the recipe loaded the init the child built in this run")
            an = rep_a["anova"]
            sig = [p["sigma1"] for p in an["pairs"]]
            say(f"anova init: rank {an['rank']} in {an['wall_s']} s (host f64, in the child "
                f"beside the phases before), axis ranks "
                f"{[a['rank'] for a in an['axis']]}, pair ranks "
                f"{[p['rank'] for p in an['pairs']]}, pair seconds "
                f"{[p['s'] for p in an['pairs']]}, pair sigma1 / the record's - 1: "
                f"{[f'{s / r - 1:+.2e}' for s, r in zip(sig, ANOVA_SIGMA1)]}")
            check(an["rank"] == 93 and [a["rank"] for a in an["axis"]] == [4] * NUM_PARAMS
                  and [p["rank"] for p in an["pairs"]] == ANOVA_PAIR_RANKS,
                  "ANOVA init rank 93: axis ranks 4, the record's pair ranks")
            check(all(abs(s / r - 1) <= 1e-6 for s, r in zip(sig, ANOVA_SIGMA1)),
                  "each pair's sigma1 within 1e-6 of the record's")
            hist_a = rep_a["history"]
            say(f"anova: {t_anova:.3f} s for {len(hist_a)} stages, rank {rep_a['rank']}, "
                f"verified max {rep_a['verified']['max']:.6e} (corners "
                f"{rep_a['verified']['corners_fem_max']:.6e}, interior "
                f"{rep_a['verified']['interior_fem_max']:.6e}); the JAX record (TPU): "
                f"stage 1 {ANOVA_STAGE1}, a 96-mode stage 2 {ANOVA_REF_MAX:.6e} at rank 189")
            stage_lines("anova", hist_a, metrics_a.rows)
            fl_a = flags_of(hist_a)
            c1, i1 = hist_a[0]["corners"], hist_a[0]["interior"]
            check(int(hist_a[0]["rank"]) == 93 and abs(c1 / ANOVA_STAGE1[0] - 1) <= 1e-5
                  and abs(i1 / ANOVA_STAGE1[1] - 1) <= 1e-5,
                  "stage 1 verifies the init at the record's corners and interior (1e-5)")
            check(len(hist_a) == ANOVA["max_stages"] and fl_a[1] == (True, True, True)
                  and int(hist_a[1]["rank"]) == 93 + ANOVA["stage_budget"],
                  "stage 2: 16 boosted, corner-seeded dd modes")
            check(hist_a[1]["max"] < hist_a[0]["max"], "stage 2 improves on the init")
            check(best_a.n_modes == int(hist_a[-1]["rank"])
                  and rep_a["verified"]["max"] == hist_a[-1]["max"],
                  "the best result is the last stage's")

            # the checkpoint holds the raw combination: its Galerkin update
            # on the base measure is the returned best result, bit for bit
            raw = load_state_npz(state_a)
            with np.load(state_a) as z:
                raw_arrays = {k: z[k] for k in z.files}
            check(raw.n_modes == best_a.n_modes and int(raw_arrays["stage"]) == len(hist_a),
                  "checkpoint rank and stage")
            for d, m in enumerate(raw.modes):
                check(np.array_equal(m.numpy(), raw_arrays[f"m{d}"]),
                      "load_state_npz reads the npz")
            again = galerkin_update(sep_base, raw)
            check(all(np.array_equal(host_f64(a)[: best_a.n_modes], host_f64(b)[: best_a.n_modes])
                      for a, b in zip(again.modes, best_a.modes)),
                  "the checkpoint reloads the raw combination exactly")
            say("anova checkpoint: reloads exactly (its Galerkin update equals the best "
                "result bit for bit)")

            # the dd contraction on the card against the CPU, on the stage-2
            # residual stack (the init leads the raw combination)
            n1 = int(hist_a[0]["rank"])
            init = PGDResult(modes=[m[:n1] for m in raw.modes], n_modes=n1,
                             amplitudes=raw.amplitudes[:n1], alpha=raw.alpha[:n1],
                             fp_its=raw.fp_its[:n1], normU0=raw.normU0)
            sep_res, _ = residual_problem(sep_boost if fl_a[1][0] else sep_base, init)
            sep_res = pad_rhs_bucket(sep_res, 4096)
            check(sep_res.num_rhs == 4096, "the stage-2 stack is one 4096-row bucket")
            dd_card_vs_cpu("anova stage-2", sep_res.rhs)

            serve_trained("fused_sweep_fields_f32_anova",
                          "parallel/vademecum.py::make_sweep_fn (ANOVA-started rank-"
                          f"{best_a.n_modes} d=5 vademecum)",
                          Vademecum(Vs_f, best_a, dim0_transform=tf_f, method="fused",
                                    device=dev),
                          pts_f, rep_a["verified"]["max"], FRONTIER_SERVE_SLACK)
    finally:
        if cache_env is None:
            os.environ.pop("PGDROME_SETUP_CACHE", None)
        else:
            os.environ["PGDROME_SETUP_CACHE"] = cache_env
        shutil.rmtree(tmp, ignore_errors=True)

    # ------------------------------------------------------------ certify
    # the committed d=10 vademecum (rank 2717) with no training: the
    # recipe's screened verification and final confirmation, the dd
    # indicator and the guaranteed bound against the JAX package's figures,
    # a certifier attached to the served vademecum
    with Phase("certify"):
        from pgdrome_tpu_torch.fem.assembly import stiffness_matrix
        from pgdrome_tpu_torch.parallel.certify import Certifier, guaranteed_field_bound

        torch.cuda.synchronize()
        peak_before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fs.reset_launch_counts()
        steps = {}

        def step(key, t0):
            steps[key] = time.perf_counter() - t0

        t0 = time.perf_counter()
        (sep10, tf10), _ = frontier_setup(D10, (8.0, 6))
        Vs10 = frontier_spaces(D10)
        state10 = load_state_npz(D10_STATE)
        step("build_and_load_s", t0)
        check(tuple(sep10.sizes) == (2047,) + (129,) * D10 and sep10.num_terms == D10 + 1
              and state10.n_modes == 2717, "the d=10 build (2047 x 129^10, T = 11), rank 2717")
        grid10 = Vs10[1].tabulate_dof_coordinates()[:, 0]
        corners10 = box_corners(grid10[1], grid10[-2], D10)

        t0 = time.perf_counter()
        verifier10 = elliptic_dense_verifier(Vs10, tf10, n_random=16,
                                             seeds=(7, 101, 1234, 777), corner_cap=2)
        sv = screened_verification(sep10, Vs10, verifier10, max_rank=state10.n_modes,
                                   device=dev)
        step("screener_build_s", t0)
        t0 = time.perf_counter()
        v10 = sv.verify(state10)
        step("screened_verify_s", t0)
        say(f"certify screened verification ({len(corners10)} corners + "
            f"{len(sv.edge_cands)} edge candidates screened, worst {sv.screen_top_k} "
            f"measured): measured max {v10['measured_max']:.6e}, estimated rest "
            f"{v10['estimated_max']:.6e} (eta {v10['eta']:.4f}), interior "
            f"{v10['interior']:.6e}, claimed {v10['max']:.6e}")
        t0 = time.perf_counter()
        final10, measured10 = screened_final(sv, state10, final_fem_corners=len(corners10))
        step("final_confirmation_s", t0)
        pts_c, _, te_c = measured10["corners"]
        idx = ((pts_c == grid10[-2]) * (1 << np.arange(D10))).sum(axis=1)
        check(sorted(idx.tolist()) == list(range(len(corners10))),
              "the final confirmation measured every corner once")
        fem10 = np.empty(len(corners10))
        fem10[idx] = te_c
        say(f"certify final confirmation: {json.dumps(final10)}")
        check(final10["corners_fem_max"] == fem10.max(), "the final confirmation's corner max")
        say(f"certify screened claim vs FEM: the stage verification's corner value "
            f"{v10['corners']:.6e} (measured top {sv.screen_top_k} and eta estimates) against "
            f"the FEM max over all corners {fem10.max():.6e}")

        t0 = time.perf_counter()
        gb = guaranteed_field_bound(sep10, Vs10, state10, tf=None, nodal_tf=tf10, device=dev)
        ind = gb.indicator
        step("guaranteed_build_s", t0)
        say(f"certify dd indicator: {ind.chunk} samples a pass")
        t0 = time.perf_counter()
        dd10 = ind(corners10)
        step("dd_indicator_s", t0)
        check(bool(np.isfinite(dd10).all()), "finite dd indicator")

        # against the JAX package's figures, computed on another machine: two
        # host f64 pipelines (assembly, banded Cholesky and LU, products)
        # agree to their forward error, ~κ(K0)·u64 of ‖u‖ or ‖b‖, not to the
        # bit; κ(K0) ≤ Gershgorin's λ_max over λ_min's guaranteed lower bound
        K0 = stiffness_matrix(Vs10[0])[1:-1, 1:-1]
        kappa = float(np.abs(K0).sum(axis=1).max()) / gb.lam_min_lower
        xm_tol = F64_ROUNDINGS * kappa * 2.0 ** -53
        lam_gap = abs(gb.lam_min_lower / D10_LAM_MIN_LOWER - 1)
        say(f"certify cross-machine f64 tolerance: {F64_ROUNDINGS} κ u64 = {xm_tol:.3e} "
            f"(κ(K0) <= {kappa:.6e}); lam_min_lower {gb.lam_min_lower!r} (record "
            f"{D10_LAM_MIN_LOWER!r}, |rel| {lam_gap:.3e}; 1e-12 asked), estimate "
            f"{gb.lam_min_estimate!r}")
        check(lam_gap <= xm_tol, "lam_min_lower equals the record's to the f64 tolerance")
        d_abs = np.abs(fem10 - np.asarray(D10_FEM))
        d_rel = d_abs / np.asarray(D10_FEM)
        worst = int(np.argmax(d_abs))
        say(f"certify FEM: max rel-L2 over the 1024 corners {fem10.max():.6e} (the record "
            f"{D10_RECORD_FEM:g} was measured on the Galerkin-updated best, the state holds "
            f"the raw combination); per corner against the JAX package's: max |Δ| "
            f"{d_abs.max():.3e} at corner {worst} (error {fem10[worst]:.6e}; bound "
            f"{xm_tol:.3e}), max |Δ|/error {d_rel.max():.3e}, median {np.median(d_rel):.3e}, "
            f"{int((d_rel <= 1e-9).sum())} corners within 1e-9 of theirs (1e-9 asked)")
        check(bool((d_abs <= xm_tol).all()),
              "per-corner FEM errors equal the JAX package's to the f64 tolerance")
        # the indicator is ‖r‖/‖b‖ ~ 1e-6: the f64 tolerance is absolute on it
        sub = list(D10_SUBSET)
        dd_tol = np.maximum(1e-5, xm_tol / np.asarray(D10_DD))
        dd_rel = np.abs(dd10[sub] / np.asarray(D10_DD) - 1)
        # on this machine: the dd indicator against the direct f64 residual of
        # the same f32 parameter tables (the dd body's inputs), and the f64
        # tables' residual, which their f32 rounding moves
        direct32, direct64 = direct_residuals(sep10, Vs10, state10, corners10[sub])
        dir_rel = np.abs(dd10[sub] / direct32 - 1)
        say(f"certify dd indicator: max {dd10.max():.6e} over the corners; at the 16 fixed "
            f"corners max |port / JAX - 1| {dd_rel.max():.3e} (bound max(1e-5, tolerance / "
            f"value): {dd_tol.min():.3e}..{dd_tol.max():.3e}; 1e-5 asked), against the "
            f"direct f64 residual of the f32 tables {dir_rel.max():.3e} (bound {DD_DIRECT:g}); "
            f"the f64 tables' residual differs by {np.abs(dd10[sub] / direct64 - 1).max():.3e}")
        check(bool((dd_rel <= dd_tol).all()),
              "the dd indicator equals the JAX package's at the 16 corners")
        check(bool((dir_rel <= DD_DIRECT).all()),
              "the dd indicator equals the direct f64 residual of its tables")
        t0 = time.perf_counter()
        g10 = gb(corners10, residuals=dd10)  # the indicator's pass above
        step("guaranteed_bound_s", t0)
        rel_gap = np.abs(g10["rel_l2"][sub] / np.asarray(D10_REL_L2) - 1)
        say(f"certify guaranteed bound: max rel_l2 {g10['rel_l2'].max():.6e} over the 1024 "
            f"corners (the record {D10_RECORD_BOUND:g}, Galerkin-updated best); at the 16 "
            f"fixed corners max |port / JAX - 1| {rel_gap.max():.3e} (the indicator's bound); "
            f"min bound / FEM {float((g10['rel_l2'] / fem10).min()):.3f}; caveat: {gb.caveat}")
        check(bool((rel_gap <= dd_tol).all()),
              "the guaranteed rel_l2 equals the JAX package's at the 16 corners")
        check(bool((g10["rel_l2"] >= fem10).all()),
              "the guaranteed bound covers the FEM error at every corner")

        t0 = time.perf_counter()
        scr10 = sv.screen(state10, corners10)
        step("screen_corners_s", t0)
        gap = np.abs(scr10 / dd10 - 1)
        overlap = len(set(np.argsort(dd10)[-16:]) & set(np.argsort(scr10)[-32:]))
        say(f"certify screener vs dd indicator over the 1024 corners: max |screen / dd - 1| "
            f"{gap.max():.3e}, median {np.median(gap):.3e} (the JAX screener's on a CPU "
            f"{D10_SCREEN['max']:.3e}, {D10_SCREEN['median']:.3e}); the dd indicator's worst "
            f"16 in the screener's worst 32: {overlap} (the JAX screener's "
            f"{D10_SCREEN['worst16_in_worst32']})")
        # the f32 screener reads a residual ~1e-6 of ‖b(p)‖ through f32 sums:
        # its noise is tens of per cent here, the JAX screener's too (which
        # misses the 1e-3 agreement and the 16-in-32 ranking as well), so it
        # is held to the reference's own noise, not to a fixed tolerance
        check(gap.max() <= 2 * D10_SCREEN["max"] and np.median(gap) <= 2 * D10_SCREEN["median"],
              "the screener's gap to the dd indicator within 2x the JAX screener's")

        cert = Certifier(ind)
        t0 = time.perf_counter()
        eta10 = cert.calibrate(corners10, fem10, residuals=dd10)  # the indicator's pass
        step("calibrate_s", t0)
        cert.attach_guaranteed(gb)
        vd10 = Vademecum(Vs10, state10, dim0_transform=tf10, method="fused",
                         device=dev).attach_certifier(cert)
        # served at the 16 fixed corners (a dd pass over all 1024 each took
        # ~11 s on an H100; the indicator's own pass above covers them).  The
        # dd sweep's f32 norms depend on how samples are batched, so the
        # served residuals are held to the 1,024-sample pass within
        # SERVED_BATCH_GAP, and the served bounds to the FEM errors there
        c16 = corners10[sub]
        t0 = time.perf_counter()
        r10 = vd10.residuals(c16)
        b10 = vd10.error_bound(c16)
        step("served_residuals_and_bounds_s", t0)
        r16 = cert.residuals(c16)
        batch_gap = float(np.abs(r10 / dd10[sub] - 1).max())
        say(f"certify served certifier: eta {eta10:.4f} (safety 1.5 over the 1024 FEM "
            f"corners), max error bound {(eta10 * dd10).max():.6e} over the 1024; served at "
            f"the 16 fixed corners: max |r16 / r1024 - 1| {batch_gap:.3e} (bound "
            f"{SERVED_BATCH_GAP:g}), min served bound / FEM "
            f"{float((b10 / fem10[sub]).min()):.3f}")
        check(batch_gap <= SERVED_BATCH_GAP,
              "the served residuals equal the 1,024-corner dd pass to the batching gap")
        check(bool((b10 >= fem10[sub]).all())
              and np.allclose(b10, eta10 * r10, rtol=1e-15, atol=0),
              "the served error bounds cover the FEM error at the 16 corners")
        # Certifier.save → load: the reloaded certifier's residuals and
        # bounds at the 16 fixed corners equal the calibrated one's
        tmp_c = Path(tempfile.mkdtemp(prefix="chip_smoke_cert_"))
        try:
            t0 = time.perf_counter()
            cert.save(tmp_c / "cert_d10.npz", spaces=Vs10)
            step("certifier_save_s", t0)
            size_c = (tmp_c / "cert_d10.npz").stat().st_size
            t0 = time.perf_counter()
            cert_re = Certifier.load(tmp_c / "cert_d10.npz", Vs10, chunk=ind.chunk, device=dev)
            step("certifier_load_s", t0)
        finally:
            shutil.rmtree(tmp_c, ignore_errors=True)
        check(np.array_equal(cert_re.residuals(c16), r16)
              and np.array_equal(cert_re.bound(c16), cert.bound(c16))
              and cert_re.eta == cert.eta,
              "Certifier.save → load: equal residuals and bounds at the 16 corners")
        say(f"certify certifier snapshot: {size_c / 2**30:.3f} GiB, save "
            f"{steps['certifier_save_s']:.3f} s, load {steps['certifier_load_s']:.3f} s; "
            "residuals and bounds at the 16 fixed corners equal bit for bit")
        del cert_re
        serve_trained("fused_sweep_fields_f32_d10",
                      "parallel/vademecum.py::make_sweep_fn (committed rank-2717 d=10 "
                      "vademecum)", vd10, corners10, float(fem10.max()), fem_bound=FEM_BOUND)
        # the fused narrow product at K = 2717 (8 sensor points at the 1024
        # corners): k-ranges of at most 512 k, their f32 partials added in f64
        s10 = torch.as_tensor(corners10, dtype=torch.float32, device=dev)
        pts10 = np.linspace(0.05, 0.95, N_PTS)
        sens10 = vd10.sensors(pts10)
        check(isinstance(sens10, fs.FusedSweep), "the d=10 sensors take the kernel")
        fs.reset_launch_counts()
        y10 = sens10(s10)
        torch.cuda.synchronize()
        launches_s10, stages_s10 = dict(fs.LAUNCHES), dict(fs.STAGE_LAUNCHES)
        check(launches_s10["sensors"] == 1 and stages_s10["sensor_fused"] == 1
              and stages_s10["partial_sum"] == 1,
              "the d=10 sensors ran the fused narrow product and the partial sum")
        K10, NP10 = int(sens10.tabs.shape[2]), int(sens10.tabs.shape[0])
        c_s10 = fs.sum_roundings(K10) + 4 * NP10
        w_s10 = hold(y10, s10, sens10.m0, c_s10, sw=sens10)
        fac_s10 = fs.fused_sweep(s10, sens10.grid, sens10.tabs, None, sens10.n_modes)
        entry("fused_sweep_sensors_d10", kernel_of(sens10, "narrow")
              + " + partial_sum_kernel<f32>",
              "parallel/vademecum.py::make_sensor_sweep_fn (committed rank-2717 d=10 "
              "vademecum, 8 points)", y10.shape, launches_s10["sensors"], w_s10,
              cuda_ms(lambda: sens10(s10), 20),
              cuda_ms(lambda: fs.fused_sweep_plain(s10, sens10.grid, sens10.tabs, sens10.m0,
                                                   sens10.n_modes), 20),
              cuda_ms(lambda: torch.matmul(fac_s10, sens10.m0), 20),
              roofline(len(corners10), N_PTS, 4, True, sw=sens10), c_s10, sw=sens10,
              host=host_split(lambda: sens10(s10)))
        say(f"certify steps (s): {json.dumps({k: round(v, 3) for k, v in steps.items()})}")
        say(f"certify peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # --------------------------------------------------------------- dual
    # goal-oriented outputs at d=10: the committed primal Galerkin-updated
    # as recipes.goal_oriented_frontier does, the committed duals, host f64
    # corrected outputs against FEM and the JAX package's figures, the
    # card's corrected sweep (primal and dual factors through the factor
    # kernel) against host f64, and the guaranteed output bound
    with Phase("dual"):
        from pgdrome_tpu_torch.convert import load_dual_states
        from pgdrome_tpu_torch.dual import (DualCorrector, corrected_sweep_bound,
                                            guaranteed_output_bound)
        from pgdrome_tpu_torch.models.problems import parametric_elliptic
        from pgdrome_tpu_torch.recipes import goal_verification_set
        from pgdrome_tpu_torch.separated import galerkin_update

        torch.cuda.reset_peak_memory_stats()
        steps = {}
        t0 = time.perf_counter()
        res_u = galerkin_update(sep10, load_state_npz(DUAL_PRIMAL))
        step("galerkin_update_s", t0)
        check(res_u.n_modes == 2688, "the d=10 primal has rank 2688")
        t0 = time.perf_counter()
        sep_d, Vs_d = parametric_elliptic(n_x=1024, n_p=128, num_params=D10, degree_x=2)
        duals = load_dual_states(DUAL_STATES, sep_d, Vs_d[0], DUAL_SENSORS)
        check(all(r.n_modes == 384 for r, _, _ in duals), "the duals have rank 384")
        samples_d, _ = goal_verification_set(D10, grid10)
        check(len(samples_d) == 1360, "the recipe's 1,360-point verification set")
        step("build_and_load_s", t0)
        t0 = time.perf_counter()
        fem_d = elliptic_fem_solver(Vs10[0], D10)
        U_d = np.stack([fem_d(p) for p in samples_d])
        step("fem_truth_s", t0)
        vd_d = Vademecum(Vs10, res_u, dim0_transform=tf10, method="fused", device=dev)
        s_d = torch.as_tensor(samples_d, dtype=torch.float32, device=dev)
        gen_d = torch.Generator(device=dev)
        gen_d.manual_seed(SEED + 10)
        lo_d, hi_d = float(grid10[1]), float(grid10[-2])
        s_rate = lo_d + (hi_d - lo_d) * torch.rand((DUAL_RATE_B, D10), generator=gen_d,
                                                   device=dev)
        ind_u = r_u = None
        for j, ((res_z, tf_z, l), x0) in enumerate(zip(duals, DUAL_SENSORS)):
            ref = DUAL_REF[j]
            t0 = time.perf_counter()
            dc = DualCorrector(sep_d, Vs10, l, res_u, tf10, res_z, tf_z)
            step(f"corrector_{j}_s", t0)
            t0 = time.perf_counter()
            s64, sp64, est64 = dc.corrected(samples_d, return_parts=True)
            step(f"host_corrected_{j}_s", t0)
            st = U_d @ l
            rel = np.abs(s64 - st) / np.abs(st)
            rel_plain = np.abs(sp64 - st) / np.abs(st)
            sub16 = np.asarray(ref["s_corr_16"])
            s16 = s64[:: len(samples_d) // 16][:16]
            gaps = {"max": abs(rel.max() - ref["max"]),
                    "median": abs(np.median(rel) - ref["median"]),
                    "plain_max": abs(rel_plain.max() - ref["plain_max"]),
                    "s_corr_16": float(np.abs(s16 / sub16 - 1).max())}
            say(f"dual x0={x0}: host f64 corrected outputs vs FEM over {len(samples_d)} "
                f"samples: max rel {rel.max():.6e} (JAX {ref['max']:.6e}), median "
                f"{np.median(rel):.6e}, plain outputs max {rel_plain.max():.6e}; gaps to the "
                f"JAX figures {json.dumps({k: float(f'{v:.3e}') for k, v in gaps.items()})} "
                f"(tolerance {xm_tol:.3e}); estimate effectivity median "
                f"{float(np.median(est64 / (st - sp64))):.6f}")
            check(all(v <= xm_tol for v in gaps.values()),
                  f"x0={x0}: host f64 corrected outputs equal the JAX package's figures")
            check(rel.max() < FEM_BOUND, f"x0={x0}: corrected outputs under 1e-6 against FEM")

            vd_d.attach_corrector(dc)
            fn_d = vd_d._corrector_fn
            check(all(isinstance(f, fs.FusedSweep) for f in fn_d.factor_sweeps),
                  "the corrected sweep's factors take the kernel")
            vd_d.corrected_sensors(s_d[:8])  # warm-up
            torch.cuda.synchronize()
            fs.reset_launch_counts()
            for sw in fn_d.factor_sweeps:
                sw.launches = 0
            s_dev = vd_d.corrected_sensors(s_d)
            torch.cuda.synchronize()
            launches_d, stages_d = dict(fs.LAUNCHES), dict(fs.STAGE_LAUNCHES)
            per_sweep = [sw.launches for sw in fn_d.factor_sweeps]
            check(launches_d["factors"] == 2 and stages_d["factors_stage"] == 2
                  and sum(launches_d.values()) == 2 and per_sweep == [1, 1],
                  "the corrected outputs ran the factor kernel once for fu and once for fz")
            bound32, c32 = corrected_sweep_bound(dc, samples_d)
            err32 = np.abs(s_dev.double().cpu().numpy() - s64)
            rel_dev = np.abs(s_dev.double().cpu().numpy() - st) / np.abs(st)
            say(f"dual x0={x0}: card f32 corrected outputs vs host f64: max |err| "
                f"{err32.max():.3e} ({(err32 / bound32).max():.4f} of its γ_c bound, c = {c32}), "
                f"{(err32 / np.abs(st)).max():.3e} of the output; vs FEM max rel "
                f"{rel_dev.max():.6e} (printed: the f32 W products floor it); launches "
                f"{json.dumps(launches_d)} (fu, fz: {per_sweep}), kernels "
                f"{json.dumps(stages_d)}")
            check(bool((err32 <= bound32).all()),
                  f"x0={x0}: the card's corrected outputs within their f32 bound of host f64")

            # the bound at every DUAL_BOUND_STRIDE-th sample: the primal's dd
            # indicator takes ~16 ms a d=10 sample on an H100
            t0 = time.perf_counter()
            gob = guaranteed_output_bound(sep_d, Vs10, l, res_u, tf10, res_z, tf_z, device=dev,
                                          primal_indicator=ind_u)
            s_b = samples_d[::DUAL_BOUND_STRIDE]
            if ind_u is None:  # the primal's residuals serve both sensors' bounds
                ind_u = gob.primal_indicator
                r_u = ind_u(s_b)
            g_d = gob(s_b, primal_residuals=r_u)
            step(f"guaranteed_bound_{j}_s", t0)
            abs_err = np.abs(s64 - st)[::DUAL_BOUND_STRIDE]
            say(f"dual x0={x0}: guaranteed output bound over {len(s_b)} of the "
                f"{len(samples_d)} samples (every {DUAL_BOUND_STRIDE}th): min bound / |error| "
                f"{float((g_d / abs_err).min()):.3f}, max bound {g_d.max():.3e} "
                f"({(g_d / np.abs(st[::DUAL_BOUND_STRIDE])).max():.3e} of the output)")
            check(bool((g_d >= abs_err).all()),
                  f"x0={x0}: the guaranteed output bound covers the FEM error at its samples")

            ms_rate = cuda_ms(lambda: fn_d(s_rate), 5)
            say(f"dual x0={x0}: {DUAL_RATE_B / ms_rate * 1e3:.4g} corrected outputs/s "
                f"({ms_rate:.3f} ms per {DUAL_RATE_B} samples, one card) on {card}")
            if j == 0:
                for label, sw, n_l in zip(("primal", "dual"), fn_d.factor_sweeps, per_sweep):
                    Kf = int(sw.tabs.shape[2])
                    out_f = sw(s_d)
                    c_f = 4 * int(sw.tabs.shape[0])
                    w_f = hold(out_f, s_d, None, c_f, sw=sw)
                    entry(f"fused_sweep_factors_dual_{label}_d10", kernel_of(sw, "F"),
                          f"dual.py::make_corrected_sensor_fn ({label} factors, K = {Kf}, "
                          f"committed d=10 states)", out_f.shape, n_l, w_f,
                          cuda_ms(lambda: sw(s_d), 20),
                          cuda_ms(lambda: fs.fused_sweep_plain(s_d, sw.grid, sw.tabs, None,
                                                               sw.n_modes), 20),
                          None, roofline(len(samples_d), Kf, 4, False, sw=sw), c_f, sw=sw,
                          host=host_split(lambda: sw(s_d)))
        say(f"dual steps (s): {json.dumps({k: round(v, 3) for k, v in steps.items()})}")
        say(f"dual peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # ---------------------------------------------------------- transient
    # the transient family: the operator-parametric conductivity primal
    # trained on the card by the minres recipe, verified against the exact
    # space-time FOM and served through the field kernels at n0 = n_x·n_t;
    # its x0 = 0.5 output certified by an adjoint cascade and served through
    # the factor kernel; a moving-heat-source vademecum trained by
    # adaptive_minres, certified
    with Phase("transient"):
        from pgdrome_tpu_torch.models.problems import (moving_heat_source,
                                                       transient_conductivity_fom,
                                                       transient_dense_verifier,
                                                       transient_parametric_conductivity)
        from pgdrome_tpu_torch.dual import (DualCorrector, corrected_sweep_bound,
                                            make_corrected_sensor_fn)
        from pgdrome_tpu_torch.parallel.certify import make_transient_certifier
        from pgdrome_tpu_torch.recipes import (_transient_sensor_duals, adaptive_minres,
                                               transient_verification_set, two_stage_minres)
        from pgdrome_tpu_torch.serving import TransientVademecum

        torch.cuda.reset_peak_memory_stats()
        steps = {}
        t0 = time.perf_counter()
        sep_t, Vs_t = transient_parametric_conductivity(**TRANSIENT)
        step("build_s", t0)
        t0 = time.perf_counter()
        res_t = two_stage_minres(sep_t, n_stage1=TRANSIENT_STAGES[0],
                                 n_stage2=TRANSIENT_STAGES[1], dtype=np.float32, device=dev,
                                 **TRANSIENT_SOLVE)
        step("two_stage_minres_s", t0)
        fp_t = np.asarray(res_t.fp_its)
        t0 = time.perf_counter()
        fom_t = transient_conductivity_fom(sep_t, Vs_t)
        pts_t = transient_verification_set(Vs_t[2].tabulate_dof_coordinates()[:, 0],
                                           TRANSIENT["num_params"])
        U_t = np.stack([fom_t(p).reshape(-1) for p in pts_t])
        step("fom_s", t0)
        vd_tr = TransientVademecum(Vs_t, res_t, device=dev)
        sw_t = vd_tr._sweep()
        check(isinstance(sw_t, fs.FusedSweep), "the space-time fields take the kernel")
        s_t = torch.as_tensor(pts_t, dtype=torch.float32, device=dev)
        vd64_t = TransientVademecum(Vs_t, res_t, dtype=torch.float64, method="torch",
                                    device=dev)
        u64_t = vd64_t.fields(s_t).cpu().numpy()
        del vd64_t
        e64_t = np.linalg.norm(u64_t - U_t, axis=1) / np.linalg.norm(U_t, axis=1)
        fs.reset_launch_counts()
        f_t = vd_tr.fields(s_t)
        torch.cuda.synchronize()
        launches_tr, stages_tr = dict(fs.LAUNCHES), dict(fs.STAGE_LAUNCHES)
        check(launches_tr["fields_f32"] == 1 and stages_tr["gemm"] >= 1
              and stages_tr["factors_stage"] == stages_tr["gemm"],
              "the space-time fields ran the field wiring's kernels")
        e32_t = (np.linalg.norm(f_t.double().cpu().numpy() - U_t, axis=1)
                 / np.linalg.norm(U_t, axis=1))
        say(f"transient primal: rank {res_t.n_modes} (the JAX package's on a CPU "
            f"{TRANSIENT_REF['rank']}), fp sweeps {int(fp_t.sum())} (mean {fp_t.mean():.2f}), "
            f"two_stage_minres {steps['two_stage_minres_s']:.2f} s; vs the space-time FOM over "
            f"{len(pts_t)} points: f64 reconstruction max rel-L2 {e64_t.max():.6e} (median "
            f"{np.median(e64_t):.3e}; the JAX package's {TRANSIENT_REF['field_rel_max']:.6e}, "
            f"the limit), kernel f32 fields {e32_t.max():.6e}; n0 = {U_t.shape[1]}; launches "
            f"{json.dumps(launches_tr)}, kernels {json.dumps(stages_tr)}")
        # a stage's rank counts its modes of positive, finite normU
        check(res_t.n_modes == sum(TRANSIENT_STAGES),
              "the transient primal kept every mode of both stages")
        check(e64_t.max() <= TRANSIENT_REF["field_rel_max"],
              "the transient primal within the JAX package's field error at rank 97")
        check(e32_t.max() <= 1.1 * e64_t.max(), "the served space-time fields vs the FOM")
        n0_t = int(sw_t.m0.shape[1])
        c_tr = fs.sum_roundings(int(sw_t.tabs.shape[2])) + 4 * int(sw_t.tabs.shape[0])
        w_tr = hold(f_t, s_t, sw_t.m0, c_tr, sw=sw_t)
        fac_tr = fs.fused_sweep(s_t, sw_t.grid, sw_t.tabs, None, sw_t.n_modes)
        entry("fused_sweep_fields_f32_transient", kernel_of(sw_t, "split")
              + " + sweep_gemm_kernel<f32>",
              "serving.py::TransientVademecum.fields (space-time fields, n0 = n_x·n_t)",
              f_t.shape, launches_tr["fields_f32"], w_tr, cuda_ms(lambda: sw_t(s_t), 20),
              cuda_ms(lambda: fs.fused_sweep_plain(s_t, sw_t.grid, sw_t.tabs, sw_t.m0,
                                                   sw_t.n_modes), 20),
              cuda_ms(lambda: torch.matmul(fac_tr, sw_t.m0), 20),
              roofline(len(pts_t), n0_t, 4, True, sw=sw_t), c_tr,
              stages=stage_ms(s_t, sw_t, n0_t), sw=sw_t, host=host_split(lambda: sw_t(s_t)))

        # the outputs of TRANSIENT_GOAL.json on this primal and its FOM
        # solves: the adjoint minres cascade's first stage for the x0 = 0.5
        # sensor at the final time, on the card, verified by the space-time
        # corrector in host f64; then the corrected outputs served on the
        # card, the primal and dual factor products through the factor kernel
        t0 = time.perf_counter()
        U_grid = U_t.reshape(len(pts_t), *sep_t.sizes[:2])
        duals_t, reps_z = _transient_sensor_duals(
            sep_t, Vs_t, res_t, pts_t, U_grid, [TRANSIENT_X0], tol_fp=TRANSIENT_SOLVE["tol_fp"],
            max_fp_it=TRANSIENT_SOLVE["max_fp_it"], dtype=np.float32, log=say, device=dev,
            **TRANSIENT_GOAL)
        step("dual_stage1_s", t0)
        res_z, rep_z = duals_t[0], reps_z[0]
        say(f"transient outputs x0={rep_z['x0']}: dual stage 1 rank {rep_z['dual_rank']}, "
            f"corrected max error vs the FOM / output scale over {len(pts_t)} points "
            f"{rep_z['corrected_best']:.6e} (bound {STAGE1_CORRECTED:g}; the JAX record's "
            f"stage 1, TPU, rank-95 primal: {TRANSIENT_GOAL_REF['stage1']:.6e} at rank "
            f"{TRANSIENT_GOAL_REF['stage1_rank']}); {steps['dual_stage1_s']:.2f} s")
        check(rep_z["dual_rank"] == TRANSIENT_GOAL["dual_stage1"]
              and len(rep_z["history"]) == 1,
              "the adjoint cascade's first stage kept its 48 modes")
        check(rep_z["corrected_best"] < STAGE1_CORRECTED,
              "the first dual stage's corrected transient outputs against the FOM")
        ix0 = int(np.argmin(np.abs(Vs_t[0].tabulate_dof_coordinates()[:, 0] - TRANSIENT_X0)))
        l_x = np.zeros(Vs_t[0].dim())
        l_x[ix0] = 1.0
        l_t = np.zeros(Vs_t[1].dim())
        l_t[-1] = 1.0
        dc_t = DualCorrector(sep_t, Vs_t, None, res_t, None, res_z, None, n_fixed=2,
                             l_factors=[l_x, l_t])
        s64_t = dc_t.corrected(pts_t)
        s_true = U_grid[:, ix0, -1]
        fn_t = make_corrected_sensor_fn(dc_t, method="fused", device=dev)
        check(all(isinstance(f, fs.FusedSweep) for f in fn_t.factor_sweeps),
              "the space-time corrected sweep's factors take the kernel")
        fn_t(s_t[:8])  # warm-up
        torch.cuda.synchronize()
        fs.reset_launch_counts()
        for sw in fn_t.factor_sweeps:
            sw.launches = 0
        s_dev_t = fn_t(s_t)[0]
        torch.cuda.synchronize()
        launches_c, stages_c = dict(fs.LAUNCHES), dict(fs.STAGE_LAUNCHES)
        per_sweep_t = [sw.launches for sw in fn_t.factor_sweeps]
        check(launches_c["factors"] == 2 and stages_c["factors_stage"] == 2
              and sum(launches_c.values()) == 2 and per_sweep_t == [1, 1],
              "the corrected outputs ran the factor kernel once for fu and once for fz")
        bound_c, c_c = corrected_sweep_bound(dc_t, pts_t)
        err_c = np.abs(s_dev_t.double().cpu().numpy() - s64_t)
        scale_t = float(np.abs(s_true).max())
        say(f"transient outputs: card f32 corrected outputs vs host f64: max |err| "
            f"{err_c.max():.3e} ({(err_c / bound_c).max():.4f} of its γ_c bound, c = {c_c}); "
            f"vs the FOM host f64 {np.abs(s64_t - s_true).max() / scale_t:.6e} (the primal's "
            f"plain outputs {np.abs(dc_t.qoi(pts_t) - s_true).max() / scale_t:.6e}), card f32 "
            f"{np.abs(s_dev_t.double().cpu().numpy() - s_true).max() / scale_t:.6e} of the "
            f"output scale; launches {json.dumps(launches_c)} (fu, fz: {per_sweep_t})")
        check(bool((err_c <= bound_c).all()),
              "the card's corrected transient outputs within their f32 bound of host f64")
        for label, sw, n_l in zip(("primal", "dual"), fn_t.factor_sweeps, per_sweep_t):
            Kf = int(sw.tabs.shape[2])
            out_f = sw(s_t)
            c_f = 4 * int(sw.tabs.shape[0])
            w_f = hold(out_f, s_t, None, c_f, sw=sw)
            entry(f"fused_sweep_factors_transient_{label}", kernel_of(sw, "F"),
                  f"dual.py::make_corrected_sensor_fn (space-time corrector, n_fixed = 2, "
                  f"{label} factors, K = {Kf}, NP = {int(sw.tabs.shape[0])})", out_f.shape, n_l,
                  w_f, cuda_ms(lambda: sw(s_t), 20),
                  cuda_ms(lambda: fs.fused_sweep_plain(s_t, sw.grid, sw.tabs, None,
                                                       sw.n_modes), 20),
                  None, roofline(len(pts_t), Kf, 4, False, sw=sw), c_f, sw=sw,
                  host=host_split(lambda: sw(s_t)))

        # the moving heat source: adaptive_minres to its bound, certified
        t0 = time.perf_counter()
        sep_h, Vs_h, fac_h, sep_err = moving_heat_source(**HEAT)
        verify_h = transient_dense_verifier(sep_h, Vs_h, fac_h, af=HEAT["af"], n_random=4,
                                            seeds=(7,))
        bound_h = max(5 * sep_err, 2e-3)
        res_h, hist_h = adaptive_minres(sep_h, verify_h, bound=bound_h, dtype=np.float32,
                                        device=dev, **HEAT_MINRES)
        step("heat_adaptive_minres_s", t0)
        say(f"heat source: separation floor {sep_err:.3e}, bound {bound_h:.3e}; stages "
            + "; ".join(f"{h['stage']}: rank {h['rank']} max {h['max']:.3e}" for h in hist_h))
        check(min(h["max"] for h in hist_h) < bound_h, "adaptive_minres reached its bound")
        P_h = Vs_h[2].tabulate_dof_coordinates()[:, 0]
        v_h = Vs_h[3].tabulate_dof_coordinates()[:, 0]
        pairs = [(i, k) for i in range(len(P_h)) for k in range(len(v_h))]
        pts_h = np.array([[P_h[i], v_h[k]] for i, k in pairs])
        t0 = time.perf_counter()
        err_h = verify_h.sample_errors(res_h, pairs)
        cert_h = make_transient_certifier(sep_h, Vs_h, res_h, fac_h)
        edge = np.array([i in (0, len(P_h) - 1) or k in (0, len(v_h) - 1) for i, k in pairs])
        eta_h = cert_h.calibrate(pts_h[edge], err_h[edge])
        vd_h = TransientVademecum(Vs_h, res_h, device=dev).attach_certifier(cert_h)
        b_h = vd_h.error_bound(pts_h)
        step("heat_certify_s", t0)
        say(f"heat source certifier: eta {eta_h:.4f} calibrated on the {int(edge.sum())} "
            f"box-edge grid points; over all {len(pairs)} grid points min bound / FOM error "
            f"{float((b_h / err_h).min()):.3f}, FOM error max {err_h.max():.3e}")
        check(bool((b_h >= err_h).all()),
              "the transient certifier's bound covers the FOM error at every grid point")
        fs.reset_launch_counts()
        s_h = torch.as_tensor(pts_h, dtype=torch.float32, device=dev)
        f_h = vd_h.fields(s_h)
        torch.cuda.synchronize()
        launches_h = dict(fs.LAUNCHES)
        check(launches_h["fields_f32"] == 1, "the heat source's fields ran the field kernels")
        sw_h = vd_h._sweep()
        n0_h = int(sw_h.m0.shape[1])
        c_h = fs.sum_roundings(int(sw_h.tabs.shape[2])) + 4 * int(sw_h.tabs.shape[0])
        w_h = hold(f_h, s_h, sw_h.m0, c_h, sw=sw_h)
        F_h = fs.fused_sweep(s_h, sw_h.grid, sw_h.tabs, None, sw_h.n_modes)
        entry("fused_sweep_fields_f32_heat", kernel_of(sw_h, "split")
              + " + sweep_gemm_kernel<f32>",
              "serving.py::TransientVademecum.fields (the heat source, n0 = n_x·n_t)",
              f_h.shape, launches_h["fields_f32"], w_h, cuda_ms(lambda: sw_h(s_h), 20),
              cuda_ms(lambda: fs.fused_sweep_plain(s_h, sw_h.grid, sw_h.tabs, sw_h.m0,
                                                   sw_h.n_modes), 20),
              cuda_ms(lambda: torch.matmul(F_h, sw_h.m0), 20),
              roofline(len(pts_h), n0_h, 4, True, sw=sw_h), c_h,
              stages=stage_ms(s_h, sw_h, n0_h), sw=sw_h, host=host_split(lambda: sw_h(s_h)))
        say(f"transient steps (s): {json.dumps({k: round(v, 3) for k, v in steps.items()})}")
        say(f"transient peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # ---------------------------------------------------------- nonlinear
    # the nonlinear family at NONLINEAR.json's widths: outer Picard of f32
    # residual cascades on the card (dd stacks from the third outer
    # iteration), verified against 76 banded-Newton truths, one dd stack of
    # the recipe contracted on the card against the CPU, and the result
    # served through the field kernels
    with Phase("nonlinear"):
        from pgdrome_tpu_torch.models.problems import (nonlinear_dense_verifier,
                                                       nonlinear_elliptic)
        from pgdrome_tpu_torch.recipes import (_CubeRhs, nonlinear_vademecum,
                                               state_conditioning)

        torch.cuda.reset_peak_memory_stats()
        steps = {}
        t0 = time.perf_counter()
        sep_n, Vs_n, ml_n = nonlinear_elliptic(**NONLINEAR)
        step("build_s", t0)
        check(tuple(sep_n.sizes) == (2049, 65, 65) and sep_n.num_terms == 3,
              "the nonlinear build: 2049 x 65^2, T = 3")
        torch.cuda.synchronize()
        fs.reset_launch_counts()
        t0 = time.perf_counter()
        res_n, tf_n, rep_n = nonlinear_vademecum(sep_n, Vs_n, ml_n, NL_EPS, dtype=np.float32,
                                                 log=say, device=dev, **NL_RECIPE, **NL_CUBE)
        step("nonlinear_vademecum_s", t0)
        hist_n = rep_n["history"]
        for h in hist_n:
            say(f"nonlinear outer {h['outer']}: rank {h['rank']}, cube terms "
                f"{h['cube_terms']}, rel_change {h['rel_change']:.6e}, rhs_comp "
                f"{h['rhs_comp']}, {h['outer_s']:.2f} s, fp sweeps {h['fp_sweeps']}, modes "
                f"repeating an earlier one dropped {h['repeated_modes']}")
        say(f"nonlinear: stop {rep_n['stop']!r} after {rep_n['outer_iterations']} outer "
            f"iterations, rank {rep_n['rank']}, {steps['nonlinear_vademecum_s']:.2f} s (the JAX "
            f"record, TPU: rank {NL_REF['rank']} after {NL_REF['outer']})")
        check(res_n.modes[0].is_cuda and res_n.modes[0].dtype == torch.float32,
              "the nonlinear solves ran in f32 on the card")
        check([h["rhs_comp"] for h in hist_n] == [i >= 2 for i in range(len(hist_n))]
              and len(hist_n) >= 3, "the outer iterations from the third on ran dd stacks")
        t0 = time.perf_counter()
        ver_n = nonlinear_dense_verifier(Vs_n, NL_EPS, ml_n, tf_n, **NL_VERIFY)
        v_n = ver_n(res_n)
        step("verify_s", t0)
        pts_n = np.concatenate(list(ver_n.samples.values()))
        say(f"nonlinear verify: f64 reconstruction max rel-L2 vs the banded-Newton truth "
            f"{v_n['max']:.6e} (corners+edges {v_n['corners']:.6e}, interior "
            f"{v_n['interior']:.6e}) over {len(pts_n)} samples, {steps['verify_s']:.2f} s; the "
            f"JAX record (TPU) {NL_REF['max']:.6e} at rank {NL_REF['rank']}")
        check(len(pts_n) == 4 + 3 * (16 + 8), "the verifier's 76 samples")
        check(v_n["max"] < FEM_BOUND, "the nonlinear vademecum under 1e-6 against Newton truth")

        # an outer iteration's extended stack [b, −ε·M_L u³] (the one the
        # next outer would solve), in dd on the card against the CPU
        t0 = time.perf_counter()
        prob_n, n_cube = _CubeRhs(sep_n, ml_n, NL_EPS, rhs_bucket=NL_RECIPE["rhs_bucket"],
                                  **NL_CUBE).problem(res_n)
        step("extended_stack_s", t0)
        check(prob_n.num_rhs % NL_RECIPE["rhs_bucket"] == 0 and n_cube > 0
              and prob_n.num_rhs >= 1 + n_cube
              and not np.asarray(prob_n.rhs[0])[1 + n_cube:].any(),
              "the extended stack: 1 + cube-term rows, zero-padded to a multiple of 512")
        dd_card_vs_cpu(f"nonlinear ({n_cube} cube terms)", prob_n.rhs)

        # served fields: the kernel within 1.1x the plain f32 version's error
        # against the truth (the plain version is the JAX package's Pallas
        # kernel's arithmetic), both under 1e-6.  Not within 1.1x the f64
        # reconstruction's, as the frontier results are: at an f64 error near
        # u32, f32 serving adds 2-4 u32 to a sum without cancellation
        # (cancellation_max 1.02 on a CPU-trained state), and the JAX
        # package's f32 serving misses 1.1x as well (on a CPU-trained state
        # of this recipe, `tests/test_torch_nonlinear.py` as a script: f64
        # 1.052e-7, its Pallas kernel 3.467e-7, its XLA sweep 2.418e-7)
        cond_n = state_conditioning(res_n, Vs_n, tf_n, pts_n)
        say(f"nonlinear state conditioning at the {len(pts_n)} samples: "
            f"{json.dumps({k: float(f'{v:.6g}') for k, v in cond_n.items()})}")
        vd_n = Vademecum(Vs_n, res_n, dim0_transform=tf_n, method="fused", device=dev)
        e_served_n = serve_trained(
            "fused_sweep_fields_f32_nonlinear", f"parallel/vademecum.py::make_sweep_fn "
            f"(nonlinear rank-{res_n.n_modes} vademecum, NP = 2)", vd_n, pts_n, v_n["max"],
            fem_bound=FEM_BOUND, truth=ver_n.truth, plain_slack=FRONTIER_SERVE_SLACK)
        say(f"nonlinear served / f64 reconstruction vs the truth: "
            f"{e_served_n / v_n['max']:.3f}")
        grid_n = Vs_n[1].tabulate_dof_coordinates()[:, 0]
        q_n = grid_n[np.random.default_rng(0).integers(1, len(grid_n) - 1,
                                                       size=(NL_SERVE, NONLINEAR["num_params"]))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f_n = vd_n.fields(q_n)
        torch.cuda.synchronize()
        step("serve_256_s", t0)
        check(tuple(f_n.shape) == (NL_SERVE, 2049) and bool(torch.isfinite(f_n).all()),
              "256 served nonlinear fields")
        say(f"nonlinear serve: {NL_SERVE} grid-point fields {tuple(f_n.shape)} in "
            f"{steps['serve_256_s'] * 1e3:.3f} ms (host clock, warm)")
        say(f"nonlinear steps (s): {json.dumps({k: round(v, 3) for k, v in steps.items()})}")
        say(f"nonlinear peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    def batch_entry(name, wiring, sweep, samples, out, table, c, factors_bound=True, **extra):
        """A kernel entry for the wiring ``sweep`` on ``samples`` (its
        output ``out``; ``table`` the M0 it multiplies): held within γ_c of
        its f64 plain version, timed beside the plain version and the
        library product.  The launches are the phase's counted run's."""
        w = hold(out, samples, table, c, sw=sweep)
        g, tb, n = sweep.grid, sweep.tabs, sweep.n_modes
        F = fs.fused_sweep(samples, g, tb, None, n)
        n_out = int(table.shape[1])
        stages = ({"stages": stage_ms(samples, sweep, n_out)} if sweep.table is not None
                  else {})
        entry(name, kernel_of(sweep, "split") + " + sweep_gemm_kernel<f32>"
              if sweep.table is not None else kernel_of(sweep, "narrow"), wiring, out.shape,
              extra.pop("launches"), w, cuda_ms(lambda: sweep(samples), 3),
              cuda_ms(lambda: fs.fused_sweep_plain(samples, g, tb, table, n), 2),
              cuda_ms(lambda: torch.matmul(F, table), 3),
              roofline(samples.shape[0], n_out, 4, True, sw=sweep), c, **stages, sw=sweep,
              **extra)
        del F
        return w

    def counted_call(counts, key, fn, *args):
        """``fn(*args)`` with the launch counts set to 0 just before it and
        read just after: ``counts[key]`` = (wiring counts, kernel counts,
        host seconds)."""
        torch.cuda.synchronize()
        fs.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        counts[key] = (dict(fs.LAUNCHES), dict(fs.STAGE_LAUNCHES), time.perf_counter() - t0)
        say(f"launches on the {key} call: {json.dumps(counts[key][0])}; kernels "
            f"{json.dumps(counts[key][1])}")
        return out

    # --------------------------------------------------------- elasticity
    # the JAX package's one 2D-space configuration run on its chip
    # (bench.py:612-662): the elasticity-ν flagship at its widths, built
    # through the setup cache, trained on the card, verified against
    # per-grid-point f64 FEM, then served through the field, sensor and
    # strain wirings
    with Phase("elasticity"):
        from pgdrome_tpu_torch.fem.derivative import gradient_function
        from pgdrome_tpu_torch.fem.function import Function
        from pgdrome_tpu_torch.models.problems import elasticity_vademecum
        from pgdrome_tpu_torch.separated import precondition_dim
        from pgdrome_tpu_torch.utils.setup_cache import cached_setup

        torch.cuda.reset_peak_memory_stats()
        steps = {}

        def _elas_build():
            sep, Vs_e, (_, bL, bR) = elasticity_vademecum(E_0=ELAS_E0, **ELASTICITY)
            # K1 alone is singular (volumetric only): the SPD term sum is the
            # congruence base
            sep_pc, tf = precondition_dim(sep, dim=0, dtype=np.float64,
                                          base=np.asarray(sep.ops[0][0]) + sep.ops[0][1])
            return sep_pc, tf, Vs_e, bL, bR, np.asarray(sep.bc_dofs[0])

        t0 = time.perf_counter()
        (sep_e, tf_e, Vs_e, bL_e, bR_e, bc_e), status_e = cached_setup(
            _elas_build, key_data=["elasticity_nu_v1", sorted(ELASTICITY.items()), ELAS_E0],
            code_objects=(elasticity_vademecum, precondition_dim),
            cache_dir=tmp / "setup_cache")
        step("build_s", t0)
        say(f"elasticity build: {steps['build_s']:.3f} s (setup cache {status_e}), sizes "
            f"{list(sep_e.sizes)} (space dofs {Vs_e[0].dim()}), T = {sep_e.num_terms}, "
            f"dim-0 factor {'banded' if tf_e.banded is not None else 'dense'}")
        check(status_e == "miss" and tuple(sep_e.sizes) == (2400, 17, 17, 17)
              and Vs_e[0].dim() == 2426 and sep_e.num_terms == 2 and tf_e.dense_L is not None,
              "the flagship build: 2426 space dofs (2400 free) x 17^3, T = 2, dense Cholesky")
        solver_e = SeparatedPGD(sep_e, dtype=np.float32, device=dev, **ELAS_SOLVE)
        t0 = time.perf_counter()
        res_e = solver_e.solve_fused()
        torch.cuda.synchronize()
        step("solve_first_s", t0)
        t0 = time.perf_counter()
        res_e = solver_e.solve_fused()
        torch.cuda.synchronize()
        step("solve_s", t0)
        fp_e = np.asarray(res_e.fp_its)
        say(f"elasticity solve: {res_e.n_modes} f32 modes in {steps['solve_s']:.3f} s (first "
            f"call {steps['solve_first_s']:.3f} s), fp sweeps total {fp_e.sum()} (mean "
            f"{fp_e.mean():.2f}, max {fp_e.max()}), {steps['solve_s'] / fp_e.sum() * 1e3:.2f} "
            f"ms/sweep")
        check(res_e.n_modes == 16 and res_e.modes[0].is_cuda
              and res_e.modes[0].dtype == torch.float32, "16 f32 modes on the card")
        del solver_e

        grids_e = [V.tabulate_dof_coordinates()[:, 0] for V in Vs_e[1:]]
        n_g = len(grids_e[0])  # the inset grid indices: 1 .. n_g − 2
        idx_e = [np.array([[(1, n_g - 2)[(c >> i) & 1] for i in range(3)] for c in range(8)])]
        for seed in ELAS_SEEDS:
            idx_e.append(np.random.default_rng(seed).integers(1, n_g - 1, size=(ELAS_RANDOM, 3)))
        idx_e = np.concatenate(idx_e)
        pts_e = np.stack([[g[i] for g, i in zip(grids_e, row)] for row in idx_e])
        t0 = time.perf_counter()
        truth_e = elasticity_truth(Vs_e[0], bL_e, bR_e, bc_e)
        u_e = np.stack([truth_e(p) for p in pts_e])
        step("truth_s", t0)

        def elas_errors(res):
            vd64 = Vademecum(Vs_e, res, dim0_transform=tf_e, method="torch",
                             dtype=torch.float64, device=dev)
            f = vd64.fields(pts_e).cpu().numpy()
            return np.linalg.norm(f - u_e, axis=1) / np.linalg.norm(u_e, axis=1), vd64

        err_e, _ = elas_errors(res_e)
        say(f"elasticity verify: the 16-mode f32 stage's f64 reconstruction max rel-L2 vs "
            f"per-grid-point f64 FEM {err_e.max():.6e} (corners {err_e[:8].max():.6e}, random "
            f"{err_e[8:].max():.6e}) over {len(pts_e)} samples, truths {steps['truth_s']:.3f} s "
            f"(the JAX package on a CPU: 8.829e-8 at the corners)")
        check(len(pts_e) == 8 + 2 * ELAS_RANDOM and err_e.max() < FEM_BOUND,
              "the 16-mode f32 stage under 1e-6 against FEM")
        t0 = time.perf_counter()
        sep_r, s_r = residual_problem(sep_e, res_e)
        delta_e = SeparatedPGD(sep_r, dtype=np.float32, device=dev, **ELAS_SOLVE).solve_fused()
        res2_e = galerkin_update(sep_e, combine_results(res_e, delta_e, s_r))
        torch.cuda.synchronize()
        step("restart_s", t0)
        err2_e, vd64_e = elas_errors(res2_e)
        say(f"elasticity restart: one f64 residual restart of {delta_e.n_modes} f32 modes "
            f"(s_res {s_r:.6e}) + Galerkin, rank {res2_e.n_modes} in {steps['restart_s']:.3f} "
            f"s; max rel-L2 vs FEM {err2_e.max():.6e} (corners {err2_e[:8].max():.6e}, random "
            f"{err2_e[8:].max():.6e}; the JAX package on a CPU: 2.252e-8)")
        check(res2_e.n_modes == 32 and err2_e.max() < FEM_BOUND,
              "the restart + Galerkin under 1e-6 against FEM")
        cond_e = state_conditioning(res2_e, Vs_e, tf_e, pts_e)
        say(f"elasticity state conditioning at the {len(pts_e)} samples: "
            f"{json.dumps({k: float(f'{v:.6g}') for k, v in cond_e.items()})}")

        # serving through B1: the verification samples (counts reset just
        # before the path), then a field batch, the vector sensors and the
        # strain fields, each call counted on its own
        vd_e = Vademecum(Vs_e, res2_e, dim0_transform=tf_e, method="fused", device=dev)
        torch.cuda.synchronize()
        fs.reset_launch_counts()
        e_served_e = serve_trained(
            "fused_sweep_fields_f32_elasticity", "parallel/vademecum.py::make_sweep_fn "
            f"(elasticity-ν flagship, rank {res2_e.n_modes}, n0 = 2426, NP = 3)", vd_e, pts_e,
            float(err2_e.max()), fem_bound=FEM_BOUND, truth=truth_e,
            plain_slack=ELAS_SERVE_SLACK)
        say(f"elasticity served / f64 reconstruction vs FEM: "
            f"{e_served_e / err2_e.max():.3f}")
        # C4 (ROADMAP): the GEMM's 8-mode FMA head when the leading modes
        # are not the first 8 — the flagship with its modes permuted so that
        # the 8 largest (max |M0 row| x the product of max |T_j row|) come
        # last, served through the kernels (which bind them first again,
        # fs.head_order), against the plain f32 version on the same
        # permuted tables
        s_pe = torch.as_tensor(pts_e, dtype=torch.float32, device=dev)
        sw0 = vd_e._sweep()
        e_plain0 = rel_rows(fs.fused_sweep_plain(s_pe, sw0.grid, sw0.tabs, sw0.m0,
                                                 sw0.n_modes), u_e)
        mag = sw0.m0.abs().amax(1).double() * sw0.tabs.abs().amax(1).double().prod(0)
        big = torch.argsort(mag, descending=True)[: fs.K_HEAD].tolist()
        perm = torch.tensor([k for k in range(vd_e.n_modes) if k not in big] + big,
                            device=dev)
        vd_pe = vd_e._derived(vd_e.spaces, [m[perm] for m in vd_e._modes])
        sw_pe = vd_pe._sweep()
        e_c4 = rel_rows(vd_pe.fields(s_pe), u_e)
        e_c4_plain = rel_rows(fs.fused_sweep_plain(s_pe, sw_pe.grid, sw_pe.tabs, sw_pe.m0,
                                                   sw_pe.n_modes), u_e)
        say(f"C4: the flagship's 8 largest modes {sorted(big)} of {vd_e.n_modes}; trained "
            f"order: kernel {e_served_e:.6e}, plain f32 {e_plain0:.6e}, ratio "
            f"{e_served_e / e_plain0:.4f}; the 8 largest last: kernel {e_c4:.6e}, plain f32 "
            f"{e_c4_plain:.6e}, ratio {e_c4 / e_c4_plain:.4f} (the flagship gate "
            f"{ELAS_SERVE_SLACK:g}), bound with modes {sw_pe.order[:fs.K_HEAD].tolist()} "
            f"first")
        check(sorted(perm[sw_pe.order[:fs.K_HEAD]].tolist()) == sorted(big)
              and e_c4 <= ELAS_SERVE_SLACK * e_c4_plain,
              "C4: the flagship with its 8 largest modes last, bound with them first, serves "
              "within the flagship gate of the plain f32 version")
        del vd_pe, sw_pe
        lo_e = torch.tensor([g[0] for g in grids_e], dtype=torch.float32, device=dev)
        hi_e = torch.tensor([g[-1] for g in grids_e], dtype=torch.float32, device=dev)
        s_e = lo_e + (hi_e - lo_e) * torch.rand((ELAS_BATCH, 3), generator=gen, device=dev)
        s_e[0], s_e[1] = lo_e, hi_e  # both ends: the right end lands in the last cell
        vd_s = vd_e.strain()
        sens_e = vd_e.sensors(ELAS_PTS)
        counted = {}
        out_e = counted_call(counted, "elasticity fields", vd_e.fields, s_e)
        rate_e = ELAS_BATCH / counted["elasticity fields"][2]
        resp_e = counted_call(counted, "elasticity sensors", sens_e, s_e)
        strain_e = counted_call(counted, "elasticity strain", vd_s.fields,
                                s_e[:ELAS_STRAIN_BATCH])
        say(f"rate elasticity fields/s one-shot ({ELAS_BATCH} x {int(out_e.shape[1])}): "
            f"{rate_e:.6g}")
        n_fields = {k: counted["elasticity " + k][0]["fields_f32"] for k in ("fields", "strain")}
        n_sens = counted["elasticity sensors"][0]["sensors"]
        check(n_fields == {"fields": 1, "strain": 1} and n_sens == 1
              and counted["elasticity sensors"][1]["sensor_fused"] == 1
              and all(counted["elasticity " + k][1]["gemm"] >= 1 for k in ("fields", "strain")),
              "the field, strain and sensor calls each ran their wiring's kernels once")
        check(tuple(resp_e.shape) == (ELAS_BATCH, 16) and tuple(strain_e.shape) == (
            ELAS_STRAIN_BATCH, 5184), "vector sensors (8 points x 2) and DG1 strain fields")
        sw_e = vd_e._sweep()
        c_e = fs.sum_roundings(int(sw_e.tabs.shape[2])) + 4 * int(sw_e.tabs.shape[0])
        batch_entry("fused_sweep_fields_f32_elasticity_batch",
                    "parallel/vademecum.py::make_sweep_fn (the flagship, 262,144 samples)",
                    sw_e, s_e, out_e, sw_e.m0, c_e, launches=n_fields["fields"],
                    rate_per_s=rate_e)
        del out_e
        check(sens_e.m0.shape == (32, 16), "the vector sensor table: components fastest")
        batch_entry("fused_sweep_sensors_elasticity",
                    "serving.py::Vademecum.sensors (8 points x 2 components of the flagship)",
                    sens_e, s_e, resp_e, sens_e.m0, c_e,
                    launches=n_sens)
        sw_s = vd_s._sweep()
        s_str = s_e[:ELAS_STRAIN_BATCH]
        batch_entry("fused_sweep_fields_f32_strain",
                    "serving.py::Vademecum.strain (DG1 Voigt strain, n0 = 576 cells x 9)",
                    sw_s, s_str, strain_e, sw_s.m0, c_e, launches=n_fields["strain"])
        del resp_e, strain_e
        # the strain table against gradient_function of the f64 reconstruction
        p4 = pts_e[:4]
        u4 = vd64_e.fields(p4).cpu().numpy()
        eps4 = []
        for u in u4:
            g4 = gradient_function(Function(Vs_e[0], u)).array.reshape(-1, 4)
            eps4.append(np.stack([g4[:, 0], g4[:, 3], g4[:, 1] + g4[:, 2]], axis=1).ravel())
        eps4 = np.stack(eps4)
        got4 = vd64_e.strain().fields(p4).cpu().numpy()
        gap4 = float(np.abs(got4 - eps4).max() / np.abs(eps4).max())
        say(f"elasticity strain table vs gradient_function of the f64 reconstruction at 4 "
            f"samples: max |gap| / max |strain| {gap4:.3e}")
        # two f64 orders of the same linear map (the modes' gradients summed,
        # or the sum's gradient): rounding only
        check(gap4 <= 1e-10, "the strain table is the reconstruction's exact strain")
        del vd64_e, vd_e, vd_s
        say(f"elasticity steps (s): {json.dumps({k: round(v, 3) for k, v in steps.items()})}")
        say(f"elasticity peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # -------------------------------------------------------------- heat3d
    # examples/heat3d_vademecum.py: a 3D P2 space dim trained in f64 on the
    # card, verified against per-sample f64 3D FEM, served in f32 through the
    # field and sensor wirings
    with Phase("heat3d"):
        from pgdrome_tpu_torch.models.problems import (elliptic3d_dense_verifier,
                                                       parametric_elliptic_3d)

        steps = {}
        t0 = time.perf_counter()
        sep_h3, Vs_h3 = parametric_elliptic_3d(**HEAT3D)
        step("build_s", t0)
        check(tuple(sep_h3.sizes) == (4913, 25, 25) and sep_h3.num_terms == 3,
              "the 3D build: 4913 x 25^2, T = 3")
        t0 = time.perf_counter()
        res_h3 = SeparatedPGD(sep_h3, dtype=np.float64, device=dev, **HEAT3D_SOLVE).solve()
        torch.cuda.synchronize()
        step("solve_s", t0)
        fp_h3 = np.asarray(res_h3.fp_its)
        check(res_h3.modes[0].is_cuda and res_h3.modes[0].dtype == torch.float64,
              "the 3D solve ran in f64 on the card")
        t0 = time.perf_counter()
        ver_h3 = elliptic3d_dense_verifier(Vs_h3, **HEAT3D_VERIFY)
        v_h3 = ver_h3(res_h3)
        step("verify_s", t0)
        say(f"heat3d: rank {res_h3.n_modes} over {Vs_h3[0].dim()} space dofs in "
            f"{steps['solve_s']:.3f} s (build {steps['build_s']:.3f} s), fp sweeps total "
            f"{fp_h3.sum()}; verified max rel-L2 vs per-sample f64 FEM {v_h3['max']:.6e} "
            f"(corners {v_h3['corners']:.6e}, interior {v_h3['interior']:.6e}) over 4 corners "
            f"+ {HEAT3D_VERIFY['n_random']} samples in {steps['verify_s']:.3f} s (reduced: the "
            f"example verifies 4 corners + 2 x 8)")
        check(v_h3["max"] < FEM_BOUND, "the 3D vademecum under 1e-6 against FEM")
        vd_h3 = Vademecum(Vs_h3, res_h3, method="fused", device=dev)
        sens_h3 = vd_h3.sensors(HEAT3D_PTS)
        s_h3 = 0.05 + 0.9 * torch.rand((HEAT3D_B, 2), generator=gen, device=dev)
        launches_h3 = {}
        f_h3 = counted_call(launches_h3, "heat3d fields", vd_h3.fields, s_h3)
        r_h3 = counted_call(launches_h3, "heat3d sensors", sens_h3, s_h3)
        n_f3 = launches_h3["heat3d fields"][0]["fields_f32"]
        n_s3 = launches_h3["heat3d sensors"][0]["sensors"]
        check(n_f3 == 1 and n_s3 == 1 and launches_h3["heat3d fields"][1]["gemm"] >= 1
              and launches_h3["heat3d sensors"][1]["sensor_fused"] == 1,
              "the 3D fields and sensors each ran their wiring's kernels once")
        check(tuple(f_h3.shape) == (HEAT3D_B, 4913) and tuple(r_h3.shape) == (HEAT3D_B, 8)
              and bool(torch.isfinite(f_h3).all()), "3D fields and 8 point sensors")
        u_c = float(r_h3[:, 0].double().mean())
        say(f"heat3d serve: u(centre) mean over {HEAT3D_B} samples {u_c:.6e}, range "
            f"[{float(r_h3[:, 0].min()):.6e}, {float(r_h3[:, 0].max()):.6e}]")
        sw_h3 = vd_h3._sweep()
        c_h3 = fs.sum_roundings(int(sw_h3.tabs.shape[2])) + 4 * int(sw_h3.tabs.shape[0])
        batch_entry("fused_sweep_fields_f32_heat3d",
                    f"parallel/vademecum.py::make_sweep_fn (3D P2, rank {res_h3.n_modes}, "
                    "n0 = 4913, NP = 2)", sw_h3, s_h3, f_h3, sw_h3.m0, c_h3, launches=n_f3)
        batch_entry("fused_sweep_sensors_heat3d",
                    "serving.py::Vademecum.sensors (8 points in the cube)", sens_h3, s_h3,
                    r_h3, sens_h3.m0, c_h3, launches=n_s3)
        del f_h3, r_h3, vd_h3
        say(f"heat3d steps (s): {json.dumps({k: round(v, 3) for k, v in steps.items()})}")

    # ----------------------------------------------------------- reference
    # the reference-parity layer (PGDProblem, PGD, PGDErrorComputation,
    # to_pgd, utils/native): host f64, run beside the device solver in f64
    # and the served kernels
    with Phase("reference"):
        from pgdrome_tpu_torch import solver as ref_solver
        from pgdrome_tpu_torch.fem import assembly as ref_assembly
        from pgdrome_tpu_torch.fem import bc as ref_bc
        from pgdrome_tpu_torch.fem.function import Function
        from pgdrome_tpu_torch.model import PGDErrorComputation
        from pgdrome_tpu_torch.models import problems as ref_problems
        from pgdrome_tpu_torch.utils import native

        steps = {}

        def step(key, t0):
            steps[key] = time.perf_counter() - t0

        def amp_limit(jax_gap):
            """The amplitude rule's bound: 1e-8, or twice the JAX pair's
            gap where that pair misses 1e-8 on the same build."""
            return AMP_RTOL if jax_gap is None or jax_gap <= AMP_RTOL else 2 * jax_gap

        def rows_rel(a, b):
            """Max over rows of max |a − b| / max |b|."""
            a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
            return float((np.abs(a - b).max(axis=1) / np.abs(b).max(axis=1)).max())

        # the truss: the example's PGDProblem on the host, SeparatedPGD in
        # f64 on the card, the amplitude rule between them
        t0 = time.perf_counter()
        prob_r, sep_r, Vs_r = truss_reference(ref_assembly, ref_bc, ref_solver, ref_problems)
        prob_r.solve_PGD()
        step("truss_host_s", t0)
        t0 = time.perf_counter()
        res_r = SeparatedPGD(sep_r, dtype=np.float64, device=dev, **TRUSS_SOLVE).solve()
        torch.cuda.synchronize()
        step("truss_device_s", t0)
        check(tuple(sep_r.sizes) == (227, 5, 201) and res_r.modes[0].is_cuda
              and res_r.modes[0].dtype == torch.float64, "the truss: 227 x 5 x 201, f64 on the card")
        g_r = amplitude_gap(prob_r._normConv, device_amplitudes(res_r))
        say(f"reference truss: PGDProblem {prob_r.PGD_modes} mode(s), amplitudes "
            f"{[float(f'{a:.12e}') for a in prob_r._normConv]} ({steps['truss_host_s']:.3f} s on "
            f"the host); SeparatedPGD f64 on the card {res_r.n_modes} mode(s), "
            f"{[float(f'{a:.12e}') for a in device_amplitudes(res_r)]} "
            f"({steps['truss_device_s']:.3f} s); gap {g_r['gap']:.3e} (bound "
            f"{amp_limit(JAX_GAP_TRUSS):g}), rest {g_r['rest']:.3e}")
        check(prob_r.PGD_modes == 1 and res_r.n_modes == 1,
              "the truss is rank 1: both paths stop after its first mode")
        check(g_r["gap"] <= amp_limit(JAX_GAP_TRUSS) and g_r["rest"] <= AMP_FLOOR,
              "the truss: the amplitude rule, PGDProblem against SeparatedPGD")

        # served through the field and sensor wirings
        vd_r = Vademecum(Vs_r, res_r, method="fused", device=dev)
        grids_r = [V.tabulate_dof_coordinates()[:, 0] for V in Vs_r[1:]]
        lo_r = torch.tensor([g[0] for g in grids_r], dtype=torch.float32, device=dev)
        hi_r = torch.tensor([g[-1] for g in grids_r], dtype=torch.float32, device=dev)
        s_r = lo_r + (hi_r - lo_r) * torch.rand((TRUSS_B, 2), generator=gen, device=dev)
        s_r[0], s_r[1] = lo_r, hi_r
        sens_r = vd_r.sensors(TRUSS_PTS)
        launches_r = {}
        f_r = counted_call(launches_r, "truss fields", vd_r.fields, s_r)
        r_r = counted_call(launches_r, "truss sensors", sens_r, s_r)
        n_fr = launches_r["truss fields"][0]["fields_f32"]
        n_sr = launches_r["truss sensors"][0]["sensors"]
        check(n_fr == 1 and n_sr == 1 and launches_r["truss fields"][1]["gemm"] >= 1
              and launches_r["truss sensors"][1]["sensor_fused"] == 1,
              "the truss fields and sensors each ran their wiring's kernels once")
        check(tuple(f_r.shape) == (TRUSS_B, 227) and tuple(r_r.shape) == (TRUSS_B, 8)
              and bool(torch.isfinite(f_r).all()), "truss fields and 8 point sensors")
        sw_r = vd_r._sweep()
        # P2 parameter dims: ≤ 8 roundings a dim (3 in each basis value, a
        # product, two sums and the product over the dims)
        c_r = fs.sum_roundings(int(sw_r.tabs.shape[2])) + 8 * int(sw_r.tabs.shape[0])
        batch_entry("fused_sweep_fields_f32_truss",
                    "parallel/vademecum.py::make_sweep_fn (the reference-style truss, rank "
                    f"{res_r.n_modes}, n0 = 227, NP = 2, P2 parameter dims)", sw_r, s_r, f_r,
                    sw_r.m0, c_r, launches=n_fr)
        batch_entry("fused_sweep_sensors_truss",
                    "serving.py::Vademecum.sensors (8 points of the truss)", sens_r, s_r, r_r,
                    sens_r.m0, c_r, launches=n_sr)

        # to_pgd at 64 served samples against the f64 plain sweep of the same
        # (served f32) modes
        pgd_r = vd_r.to_pgd(name_coord=["X", "P", "E"])
        vd64_r = Vademecum(Vs_r, vd_r.result, dtype=torch.float64, method="torch", device=dev)
        s64_r = s_r[:TRUSS_EVAL].double()
        pts_r = np.asarray(TRUSS_PTS)
        ref_f = vd64_r.fields(s64_r).cpu().numpy()
        ref_s = vd64_r.sensors(TRUSS_PTS)(s64_r).cpu().numpy()
        t0 = time.perf_counter()
        ev_f = np.stack([pgd_r.evaluate(0, [1, 2], list(p), 0).array
                         for p in s64_r.cpu().numpy()])
        ev_s = np.stack([pgd_r.evaluate_sensor_response(0, [1, 2], list(p), 0, pts_r)
                         for p in s64_r.cpu().numpy()])
        step("truss_to_pgd_eval_s", t0)
        e_tf, e_ts = rows_rel(ev_f, ref_f), rows_rel(ev_s, ref_s)
        say(f"reference truss to_pgd: PGD.evaluate / evaluate_sensor_response at {TRUSS_EVAL} "
            f"served samples vs the f64 plain sweep of the same modes: max rel {e_tf:.3e} / "
            f"{e_ts:.3e} (bound {EVAL_REL:g})")
        check(e_tf <= EVAL_REL and e_ts <= EVAL_REL, "the truss's to_pgd evaluations")

        # PGDErrorComputation against the analytic FOM on both PGDs
        x_r = Vs_r[0].mesh().coordinates()[:, 0]
        lim_r = [None] + [[g[0], g[-1]] for g in grids_r]
        pgd_dev = Vademecum(Vs_r, res_r, dtype=torch.float64, method="torch",
                            device=dev).to_pgd(name_coord=["X", "P", "E"])
        e_host = PGDErrorComputation(fixed_dim=[0], n_samples=10, FOM_model=truss_fom(x_r),
                                     PGD_model=prob_r.return_PGD()).evaluate_error()
        e_dev = PGDErrorComputation(fixed_dim=[0], n_samples=10, FOM_model=truss_fom(x_r),
                                    PGD_model=pgd_dev, lim_samples=lim_r).evaluate_error()
        say(f"reference truss PGDErrorComputation (10 LHS samples, seed 3452) vs the analytic "
            f"FOM: mean rel-L2 {e_host[1]:.12e} (return_PGD) / {e_dev[1]:.12e} (to_pgd of the "
            f"card's solve), |diff| {abs(e_host[1] - e_dev[1]):.3e} (bound {PGD_ERR_EQ:g})")
        check(abs(e_host[1] - e_dev[1]) <= PGD_ERR_EQ, "the two PGDs' mean errors")
        del f_r, r_r, vd_r, vd64_r, sens_r

        # the d=5 vademecum through the reference API
        t0 = time.perf_counter()
        pgd5 = vd.to_pgd()
        vd5_64 = Vademecum(vd.spaces, vd.result, dtype=torch.float64, method="torch", device=dev)
        ref5 = vd5_64.fields(torch.as_tensor(corners, device=dev)).cpu().numpy()
        ev5 = np.stack([pgd5.evaluate(0, list(range(1, 6)), list(c), 0).array
                        for c in corners])
        e5 = rows_rel(ev5, ref5)
        step("d5_to_pgd_s", t0)
        say(f"reference d=5: to_pgd evaluate at the {len(corners)} inset corners vs the f64 "
            f"plain sweep of the same modes: max rel {e5:.3e} (bound {EVAL_REL:g})")
        check(e5 <= EVAL_REL, "the d=5 to_pgd evaluations")
        V0 = vd.spaces[0]
        t0 = time.perf_counter()
        err5 = PGDErrorComputation(
            fixed_dim=[0], n_samples=32, lim_samples=[None] + [[grid_p[1], grid_p[-2]]] * 5,
            FOM_model=lambda p: Function(V0, fem(p)).compute_vertex_values(), PGD_model=pgd5)
        errs5, mean5, max5 = err5.evaluate_error()
        step("d5_pgd_error_s", t0)
        lhs5 = np.asarray(err5.data_test)
        s5 = torch.as_tensor(lhs5, dtype=torch.float32, device=dev)
        launches5 = {}
        served5 = counted_call(launches5, "d5 LHS fields", vd.fields, s5)
        check(launches5["d5 LHS fields"][0]["fields_f32"] == 1
              and launches5["d5 LHS fields"][1]["gemm"] >= 1,
              "the d=5 LHS samples ran the field wiring's kernels")
        w5 = hold(served5, s5, fused.m0, fs.sum_roundings(K) + 4 * NUM_PARAMS)
        u5 = np.stack([fem(p) for p in lhs5])
        e_served5 = rel_rows(served5, u5)
        say(f"reference d=5 PGDErrorComputation (32 LHS samples in the inset box, seed 3452): "
            f"FEM max rel-L2 {max5:.6e} (mean {mean5:.6e}, vertex values); the same points "
            f"served by the field kernels: FEM max rel-L2 {e_served5:.6e} (all dofs), kernel "
            f"vs plain {w5['vs_plain']:.3e} ({w5['ratio']:.3f} of its f64 bound)")
        check(max5 < FEM_BOUND and e_served5 < FEM_BOUND,
              "the d=5 vademecum under 1e-6 at the LHS points, through to_pgd and served")
        del vd5_64, served5

        # bench.py's reference-architecture baseline, 3 modes at bench's widths
        sep_b, Vs_b = ref_problems.parametric_elliptic(**TRAIN_BUILD)
        prob_b = ref_problems.pgd_problem_from_separated(sep_b, Vs_b)
        prob_b.tol_fp_it = BASELINE_SOLVE["tol_fp"]
        prob_b.max_fp_it = BASELINE_SOLVE["max_fp_it"]
        amps_b, secs_b = bench_baseline(prob_b, BASELINE_MODES, BASELINE_SOLVE["tol"])
        t0 = time.perf_counter()
        res_b = SeparatedPGD(sep_b, dtype=np.float64, device=dev, **BASELINE_SOLVE).solve()
        torch.cuda.synchronize()
        step("baseline_device_s", t0)
        g_b = amplitude_gap(amps_b, device_amplitudes(res_b))
        say(f"reference baseline (bench.py:685-760, {list(sep_b.sizes)}, T = {sep_b.num_terms}): "
            f"host seconds per mode {[round(t, 3) for t in secs_b]} on {card}; amplitudes "
            f"{[float(f'{a:.12e}') for a in amps_b]}; SeparatedPGD f64 on the card "
            f"{[float(f'{a:.12e}') for a in device_amplitudes(res_b)]} in "
            f"{steps['baseline_device_s']:.3f} s; gap {g_b['gap']:.3e} (bound "
            f"{amp_limit(JAX_GAP_BASELINE):g}), rest {g_b['rest']:.3e}")
        check(len(amps_b) == BASELINE_MODES and res_b.n_modes == BASELINE_MODES
              and g_b["gap"] <= amp_limit(JAX_GAP_BASELINE) and g_b["rest"] <= AMP_FLOOR,
              "the baseline build: the amplitude rule, PGDProblem against SeparatedPGD")
        steps["baseline_host_s"] = sum(secs_b)
        del prob_b, res_b, sep_b

        # utils/native on the card's machine
        from scipy.linalg import solve_banded

        rng_n = np.random.default_rng(SEED)
        n_n = 2049
        dl_n, du_n = rng_n.random(n_n), rng_n.random(n_n)
        d_n, b_n = 4.0 + rng_n.random(n_n), rng_n.standard_normal(n_n)
        x_n = native.thomas_solve(dl_n, d_n, du_n, b_n)
        ab = np.stack([np.concatenate([[0.0], du_n[:-1]]), d_n, np.concatenate([dl_n[1:], [0.0]])])
        x_ref = solve_banded((1, 1), ab, b_n)
        e_n = float(np.abs(x_n - x_ref).max() / np.abs(x_ref).max())
        say(f"reference native: available {native.available()} ({native._lib_path().name}), "
            f"thomas_solve on {n_n} rows vs scipy solve_banded: max rel {e_n:.3e}")
        check(native.available() and e_n <= 1e-12, "utils/native builds, loads and solves")
        say(f"reference steps (s): {json.dumps({k: round(v, 3) for k, v in steps.items()})}")

    peak = max(peak_before, torch.cuda.max_memory_allocated())
    say(f"peak device memory: {peak / 2**30:.3f} GiB")
    say(f"wall seconds: {time.perf_counter() - t_start:.1f}")
    say(card)  # name and power limit, as nvidia-smi gives them
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--anova-init"]:
        sys.exit(anova_init_child(sys.argv[2]))
    sys.exit(main())
