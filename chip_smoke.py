"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --temperature-study   # see temperature_study()

Phases, one line of numbers each:

1. build   - compile ``pmarlo_tpu_torch/csrc`` with nvcc (sm_90a), one
             nvcc a source, all started together; the registers and spills
             ptxas reports for the six fused kernels (the chunk and the
             whole-run REMD kernel, each also as a *_single_kernel build,
             and the two biased ones), the three dense GB
             block kernels (``pair_born_kernel``, ``pair_energy_kernel``,
             ``pair_force_kernel``), the three Newton kernels, the three
             ordered culled kernels (``pair_{born,energy,force}_culled_kernel``),
             the bonded kernel's two passes (``bonded_term_kernel``,
             ``bonded_atom_kernel``) and the explicit-solvent kernels
             (``periodic_force_kernel``, ``cell_force_kernel``,
             ``periodic_slots_kernel``, ``cell_pack_kernel``) (no spill
             allowed).
2. kernel  - the fused Langevin kernel against its plain PyTorch twin at
             R=32 on alanine dipeptide in GBn2: energies and forces, then
             100 steps at friction 0 and at friction 1/ps, two launches
             bitwise equal; then us a step at R = 8, 32, 128, 512 with the
             launch shape chosen (CTAs a replica C, lanes an atom team L,
             lanes a pair team T, steps a lane an iteration P, threads),
             and ms per 100 steps of every shape at R=32.
3. thermo  - 10,000 kernel steps at 1/ps on the 300-450 K ladder: the
             ladder-averaged kinetic/target temperature ratio.
4. remd    - the main path: 32-replica REMD, 20,000 steps, one kernel
             launch per exchange window, then phi/psi -> MSM -> FES on
             rungs 0-3, and the 35-shard synthetic MSM build.
5. times   - REMD aggregate ns/day for the kernel and the plain path, and
             the warm MSM build.
6. pair    - the three GB pair kernels against their plain twins on the
             3,726-atom chignolin assembly (R=8, minimized + 0.005 nm
             noise): Born integrals, energy rows, dE/dB, forces, then the
             whole energy and forces, and both against a float64 twin
             (the forces at most 1e-5 of max |F| from it, the energy at
             most 1e-5 relative; its distance read again with only the
             Born or only the energy kernel in the evaluation); the pairs
             whose HCT value takes the near form (the Born bound); two
             launches of each of the three kernels bitwise equal; ms per sweep and per
             evaluation, and of the three Newton kernels over the whole
             upper triangle at the same shape against their plain versions
             (a point of comparison).
7. protein - the protein-scale path: 8-rung 300-330 K REMD of the assembly
             with every X-H bond constrained at 4 fs and 5/ps, through
             ``run_replica_exchange`` (pair kernels, FIRE, SHAKE/RATTLE,
             swaps); launches, ns/day, acceptance, temperature,
             constraint deviation. Its step count is cut to fit the time
             limit; atoms and replicas are not.

8. bias    - the in-kernel DeepTICA CV bias on 138-atom chignolin, R=32,
             a default-width model with random weights: harmonic and
             hills-ledger (1,000 hills) energies and forces against the
             plain version and against autograd of ``bias/`` over ``ml/``,
             100 biased steps at friction 0 and 1/ps, ms per 100 steps
             biased beside unbiased at N=138 and N=22, two launches of each
             bitwise equal, the R and shape sweeps of phase 2 at N=138, and
             the cost of one grid barrier (also in clusters of 4 CTAs).
9. fused   - the whole REMD run in one launch: ``run_fused`` against
             ``run(use_kernel=True)`` window for window over 10 windows,
             then 10,000 steps at full size, wall and ns/day beside the
             windowed path's; then both whole-run kernels against the
             plain version over launches of 2, 2 and 1 windows with
             swaps, each from the state the one before left. Unbiased
             and with ``kernel_bias``. Then the unbiased kernel timed on 2
             windows: ms a call (CUDA events) beside its device time
             (``torch.profiler``).
10. cv     - the learned-CV path end to end: REMD frames -> phi/psi
             features -> ``train_deeptica`` -> biased windows and a biased
             ``run_fused`` -> ``run_fused_metadynamics`` -> sampling under
             the ledger -> reweighted FES on the two CVs.

11. periodic - the dense minimum-image kernel on the shipped 2,315-atom
             solvated chignolin (R=8, minimized + 0.005 nm noise), shifted
             and switched LJ: against its plain version and against
             autograd of the dense periodic energy (float64: atoms with a
             pair on the cutoff, which float32 may cut the other way, are
             counted and left out); two launches bitwise equal; the walk's
             32 x 32 patches, pairs queued and pairs a batch; ms per sweep
             and per evaluation; the bound from the walk's pairs (each
             unordered pair inside the cutoff once).
12. cells  - the cell-list kernel: (a) on the same inputs against its
             plain version, the dense oracle and the periodic kernel, in
             reaction-field, switched and smooth-PME mode (phase 11's
             atoms on the cutoff left out against the oracle and the
             periodic kernel, whose r^2 round differently), and in
             reaction-field mode at R=8 (phase 13's shape, 3 x 3 x 2
             cells) two launches bitwise equal, the walk's figures, ms a
             sweep against its bound; (b) on a sheared 375-atom water box
             against the oracle; (c) on the 27,783-atom water box at R=1
             and R=4 against its plain version, two launches bitwise
             equal, the walk's figures, ms per sweep, per binning pass and
             per evaluation, the bound from the walk's pairs;
             (d) 200 MD steps under the displacement rule (``_SkinRule``):
             ``evaluate`` on the kept assignment equals a fresh evaluation.
13. explicit remd - ``run_replica_exchange`` on the solvated chignolin
             file, 8 rungs 300-330 K, rigid water and X-H constraints at
             2 fs and 5/ps, 400 steps, once through "auto" (the dense
             kernel) and once through "cells": launches, ms a step, ns/day,
             acceptance, temperature, constraint deviation.
14. water md - ``thermalize`` + ``run_md`` on the 27,783-atom water box
             through the cell kernel (a sort every step): ms a step,
             ns/day, temperature, constraint deviation; the energy drift of
             500 steps at friction 0 (under 1 kT per degree of freedom per
             ns); the same path under the displacement
             rule, two stretches of each from one start, alternating.

15. large kernels - the tile-culled and the Newton pair kernels on the
             24,840-atom chignolin assembly (180 copies), ``gb_cutoff=1.5``,
             tiles of 128 in a Morton order of the start geometry, R=1 and a
             batch of 3: each of the six sweeps against its plain version,
             Newton against ordered, Newton run to run (its sums are atomic),
             a huge cutoff against the dense kernels, Morton against identity
             order; the share of tile blocks computed; of the 32 x 32
             patches of the kept blocks, the share that the group-box test
             lists (the work items of all three Newton kernels) and the
             share of items that holds a pair inside the cutoff; ms a sweep
             beside the dense kernels' at the same N, and of the patch
             list's build; bounds from this run's pairs.
16. bonded - the bonded kernel on the same assembly against
             ``bonded_energy_and_forces`` and float64 autograd, two launches
             bitwise equal; ms of the kernel alone (a CUDA graph of 50
             calls) beside ms a call.
17. large path - the large implicit-solvent path at full width: 61,824
             atoms (448 copies), ``build_pair_force_fn(tile=128,
             gb_cutoff=1.5, order_from=x0)`` (Newton sweeps and the bonded
             kernel by default) -> ``minimize_energy`` (300 FIRE iterations)
             -> ``thermalize`` -> ``run_md`` at 4 fs with every X-H bond
             constrained, 50 warm-up steps and a timed 2.4 ps: ms a force
             evaluation, ms a step, ns/day, temperature, constraint
             deviation, peak device memory; then a short stretch of the same
             run through the ordered culled sweeps (``newton=False``); then
             the six sweeps and the bonded kernel against their plain
             versions at this width, at the positions the run arrived at
             (the ``kernels`` line takes their errors, times and bounds from
             here), the bonded kernel and the three ordered sweeps alone (a
             CUDA graph of 50 calls) beside a call and each twice bitwise
             equal, the ordered sweeps' walk replayed on the host (patches,
             pairs queued, pairs a batch), and ms of the patch list's build.
             Two temperatures
             are printed: ``run_md``'s reported one over the second half,
             which at 4 fs settles ~12% under the target, and the state's
             mid-step one, which is gated to [0.9, 1.1] at 2.0 and 2.6 ps
             (``--temperature-study`` measures both at 4 fs and 2 fs).

18. production segment - ``pmarlo_tpu_torch.run_segment`` on the shipped
             solvated chignolin (2,315 atoms, 3.00 x 2.85 x 2.68 nm, a 3 x 3
             x 2 cell grid at 0.9 nm) with ``nonbonded="pme"``,
             ``ensemble="npt"``: 400 steps at 2 fs and 5/ps, a volume move
             every 25, frames every 100 to an .xtc file, then 100 steps resumed from
             its final state and barostat state: wall, ms a step (and of
             its force call), ns/day,
             acceptance, density, box trace, T over the second half,
             constraint deviation, launches; at the final positions and box
             PME through the kernel against the plain half-shell version,
             both against a dense float64 Ewald oracle (``md/pme.py``'s
             terms on the cell path's mesh), ``dynamic`` against a fresh
             build at that box; the .xtc read back against the frames.
19. pme water - the same entry point on the 27,783-atom water box (a
             temporary PDB): 100 warm-up steps (100 FIRE iterations first),
             then 500 NPT steps resumed: ms a step, acceptance, density
             trace, peak device memory; one evaluation split by CUDA events
             into binning, the row 9 sweep, the band correction, the spread,
             the FFT with the influence function, and the gather by
             autograd; two evaluations run to run; a volume move into a box
             whose cell layers are thinner than the cutoff: NaN energy,
             rejected, and no synchronisation with the host while it runs.
20. tip4pew segment - virtual-site water on the production path: the
             chignolin structure solvated in TIP4P-Ew (``solvate_structure(
             padding=1.0, water_model="tip4pew")``, 4,260 rows, 1,030 of
             them M sites) through ``run_segment(nonbonded="pme",
             ensemble="npt")``: 300 FIRE iterations, 400 steps at 2 fs and
             5/ps to an .xtc file, 100 steps resumed; ms a step, ns/day, the share of
             a step that the site expansion and spread take, acceptance,
             density, T over the second half with the site-free degrees of
             freedom, constraint deviation, the sites against their parents
             in every frame; at the final positions and box the row 9 kernel
             (Ewald mode, the sites charged atoms without LJ) against its
             plain version and a dense float64 PME oracle through the
             expansion; then g(r) of the water oxygens from the .xtc read
             back (first peak position and height gated) and the oxygens'
             diffusion coefficient (reported, not gated: the run is short).
21. tip5p box - 1,000 TIP5P waters (5,000 rows, the L1 / L2 sites out of
             the HOH plane) through ``run_segment(nonbonded="dense")``: 100
             FIRE iterations and 200 NVT steps, then 500 NVE steps
             resumed; row 8 against its plain version at the start and the
             end, NVE drift with the site-free degrees of freedom (phase
             14's gate), the sites against their parents in every frame.
22. analysis - the analysis half on phase 4's frames (no REMD of its own):
             phi/psi of rungs 0-3 by ``compute_ramachandran`` against phase
             4's cos/sin features, TICA (lag 2, 2 components), k-means to
             16 states, the MSM at lag 2, the ITS ladder over lags 1-10
             with 100 Dirichlet samples and with the reversible posterior,
             CK at factors 2 and 3, the CK/ITS lag selector, PCCA+ into 2
             macrostates, committors and reactive flux between them, the
             Ramachandran FES of the 300 K rung and the KDE FES of the TICA
             coordinates; then on phase 4's synthetic 35-shard set (k=50,
             lag 10) the ITS ladder with both posteriors over 5 lags, PCCA+
             and TPT, and TPT on the 8 x 8 drunkard's-walk lattice; gates on
             each result, host wall seconds of each step.
23. conformations - the end of config 4 on phase 10's unbiased REMD frames
             (no MD of its own): SASA (Shrake-Rupley, 96 points, chunked),
             H-bond counts and phi/psi fractions over all 32 x 200 walker
             frames through ``featurize_trajectory`` (CUDA events, peak device
             memory added), 64 of them again on the CPU (equal but at a
             threshold, counted); Kabsch-Sander DSSP and Baker-Hubbard on the
             card, 64 frames against the CPU; one frame of the 3,726-atom
             assembly's SASA, chunked, against the CPU and against its 27
             copies alone (an atom can only lose area); ``EnhancedMSM`` on
             rungs 0-3 (TICA, k-means, MSM, ITS, macro CK, FES, state table,
             representative PDBs, saved results); ``find_conformations`` on
             the active block with representatives and the TPT bootstrap;
             gates on each result, host wall seconds of each step.
24. structure prep - the user's path from a raw PDB: the 3,726-atom
             assembly stripped of every hydrogen and OXT, TYR cut at CB and
             TRP at CG, THR 8 of every copy made TPO with a phosphate, TYR 2 and
             ASP 3 taken out of chain A (``raw_chignolin_assembly``) ->
             ``Protein.prepare`` -> ``add_missing_residues`` -> ``prepare``
             (the assembly's residues, names, order and charge; raw heavy
             atoms unmoved; rebuilt bonds near r0; the closure) ->
             ``create_system()`` on the card, rows 3-5 against their plain
             versions at the prepared and the minimized positions (R=8),
             one evaluation under ``profiling.trace`` -> the CLI in this
             process: ``info``, ``remd`` (8 rungs 300-330 K, 1,000 steps at
             4 fs with X-H constraints: the pair kernels every force
             evaluation) and ``run-segment`` (200 steps) on the saved PDB;
             the three as stages of a ``workflow.Pipeline``, run again from
             its checkpoint (every stage replayed); ``StageTimer``'s summary.
25. nucleic complex - chain A of phase 24 beside a DNA (GATC) and an RNA
             (GACU) strand (264 and 265 atoms): ``add_hydrogens``,
             ``build_system`` on the card (charge -3 from the strand), 2,000
             FIRE iterations, ``ReplicaExchange(use_kernel=True)`` at R=8:
             row 1 against its plain version over one 100-step chunk (phase
             2's gate), then 4 ps of equilibration and 2,000 steps at 1 fs,
             the ladder's and each rung's kinetic/target temperature.
26. api and reports - ``api.extract_last_frame_to_pdb`` writes phase 10's
             last 300 K frame; ``run_replica_exchange(pdb, use_kernel=True)``
             restarts from it at phase 10's ladder through row 1 (its System
             equal to phase 10's field by field; row 1 against its plain
             version over one 100-step chunk at the restart positions, phase
             2's gates); the ``api`` facade on rungs 0-3 on the card (features
             and their cache, alignment, the universal embedding, k-means,
             MSM, macrostates, FES minima, conformations, ``benchmark``);
             ``api.analyze_msm`` with its plots, the ``visualization`` plots,
             the interactive pages, and the dashboard (``webapp``) exported,
             through the CLI and served once on the loopback. Without
             matplotlib on the host the steps that render are listed and not
             run.

27. multi-device - two ranks spawned on the one card (gloo with CUDA
             tensors, a FileStore in a temporary directory; NCCL refuses two
             ranks on one device) while this process runs the one-rank
             references: phase 4's 32-replica alanine REMD on the plain
             path, 2,000 steps, 16 rungs a rank; phase 7's 8-replica
             3,726-atom REMD through rows 3-5, 100 steps at 4 fs, 4 rungs a
             rank (each held: identical ids and acceptance, frames within
             1e-4 nm; from one minimized structure); the checkpoint of the
             sharded alanine run written and read back under the mesh; the
             41,472-atom water box through row 9 in x-slabs (``run_md``, the
             slab launches counted; then RF, PME and a box sheared by JAX's
             dry-run tilt ratios, each against the unsharded kernel and
             against the plain slab sweep: ms a sweep, scratch bytes a rank
             beside the unsharded); one data-parallel DeepTICA step at the
             defaults (32 x 200 frames x 32 features) against the serial
             step.
28. neighbor list - the neighbor-listed GB path (``md/nblist.py``, plain
             PyTorch) and the roll layouts on phase 7's minimized 3,726-atom
             assembly: (a) ``potential_energy_nb`` and its autograd forces,
             the list at 1.5 nm without skin, against the pair path cut at
             1.5 nm in its Newton mode (rows 7 and 10) and ordered (rows 6
             and 10) at warmed positions, and at the minimized ones in
             float64 against the pair path's float64 version, n_max beside
             the capacity; (b) ``run_md_nb`` 400 steps
             at 2 fs, 1/ps, cutoff 2.0 + skin 0.2, a rebuild every 20 steps
             (JAX's test settings), from a state warmed 300 steps on row 7 at
             5/ps, ms a step beside ``run_md`` on row 7 at 2.0 nm from the
             same state, list build ms, peak device memory; (c)
             ``build_rolled_bonded`` against the index-gathered bonded terms,
             ``shake_rolled`` / ``rattle_rolled`` against ``shake`` /
             ``rattle`` on the index layout's spec, and 100 constrained
             ``run_md`` steps at 4 fs with
             ``build_h_constraints(layout="rolled")`` (the index layout's
             100 steps timed beside; a rolled spec runs the same solver on
             the constraints it reads off its masks).

As each phase ends, its wall seconds and the script's so far go to
standard error (a run cut at its time limit shows how far it got).
Then a summary line that repeats the headline numbers of phases 1,
11-14 and 15-28 and every phase's wall seconds, the card's name and
power limit, a line of the kernels'
times before their redesign (the one-thread-an-atom and the row-owned fused kernels, the
row-owned dense Born and energy sweeps, the Newton Born and energy sweeps'
block walk, the row-owned periodic and cell sweeps, the one-pass bonded
kernel and the row-owned culled sweeps) copied from PERF.md
(for comparison; not measured here), one JSON line of the kernels, and the last line
``{"ok": true, "device": {...}}``. A failed check raises and the script
exits non-zero without that line. It needs a CUDA card and
imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

N_REPLICAS = 32
N_STEPS = 20_000
DT_PS = 0.002
EXCHANGE_FREQUENCY = 100
PLAIN_STEPS = 500                # the plain path's timed REMD (cut from 2,000, then 1,000)
PROTEIN_COPIES = (3, 3, 3)        # 27 chignolins, 3,726 atoms
PROTEIN_REPLICAS = 8
# cut to fit (from 2,000, then from 1,000): 29-41 ms a step on the H100's
# host; phase 24 runs the same system and ladder (at 1/ps, the CLI's
# default) through the CLI for 1,000
PROTEIN_STEPS = 300
PROTEIN_DT_PS = 0.004
# phase 6: the pair path's forces against a float64 evaluation, at most 1e-5
# of max |F| (the force kernels take single special-function results)
FORCE_VS_FLOAT64_MAX = 1e-5
# and the whole energy against the float64 evaluation (exact ke and gb_pref),
# at most 1e-5 relative, the limit of the energy gates against plain: the
# dense kernels read 6.2e-6 to 6.5e-6 there, the plain float32 evaluation
# 4.8e-6 to 4.9e-6 (PERF.md section 6)
ENERGY_VS_FLOAT64_MAX = 1e-5
PAIR_KERNELS = ("pair_born", "pair_energy", "pair_force")
CV_REPORT = 50                   # frames every 50 steps on the chignolin paths
CV_STEPS = 10_000                # unbiased REMD that feeds the training
CV_BIASED_STEPS = 1_000          # biased windows, one launch a frame
CV_FUSED_STEPS = 10_000          # whole-run launches
MTD_STEPS = 5_000
MTD_INTERVAL = 500
MTD_SIGMA = (0.2, 0.2)
PLAIN_LAUNCHES = (2, 2, 1)       # windows a launch: whole-run kernels vs plain
LEDGER_FRAMES = 100              # sampling under the final ledger
N_HILLS_CHECK = 1_000            # valid hills of the ledger-variant check
BIAS_VARIANTS = ("bias_harmonic", "bias_metadynamics", "fused_metadynamics",
                 "fused_remd")
SOLVATED_PDB = "examples/outputs/explicit_solvent/chignolin_solvated.pdb"
EXPLICIT_REPLICAS = 8
EXPLICIT_STEPS = 400             # cut from 2,000 to fit: ~50 ms a step, host-bound
EXPLICIT_REPORT = 50
EXPLICIT_CUTOFF = 0.9
EXPLICIT_SWITCH = 0.8
# OpenMM's alpha for a real-space tolerance of 5e-4 at the 0.9 nm cutoff
EWALD_ALPHA = float(np.sqrt(-np.log(2.0 * 5e-4)) / EXPLICIT_CUTOFF)
WATER_SIDE = 21                  # 21^3 waters = 27,783 atoms, box 6.61 nm
WATER_WARM_STEPS = 100
WATER_STEPS = 500                # cut from 1,000 to fit
WATER_REBIN_STEPS = 200          # a stretch of the rebin comparison (cut from 300)
WATER_REBIN_ROUNDS = 2           # stretches of each policy, alternating (cut from 3 to fit)
WATER_NVE_STEPS = 500
# phase 14's bound on the energy drift of those steps, kT per degree of
# freedom per ns (read 0.056-0.209 in PR 4-10's runs, PERF.md)
NVE_DRIFT_MAX = 1.0
SKIN_STEPS = 200
LARGE_CHECK_COPIES = (6, 6, 5)   # 180 chignolins, 24,840 atoms
LARGE_COPIES = (8, 8, 7)         # 448 chignolins, 61,824 atoms
LARGE_TILE = 128
GB_CUTOFF = 1.5
LARGE_FIRE = 300
LARGE_WARM_STEPS = 50
LARGE_STEPS = 600                # the timed stretch through the Newton sweeps (2.4 ps)
LARGE_ORDERED_STEPS = 50         # the same run through the ordered culled sweeps
LARGE_DT_PS = 0.004
STUDY_PS = 6                     # picoseconds at each time step of --temperature-study
# phase 18: run_segment on solvated chignolin, NPT + PME; cut from 5,000 + 1,000
# steps, then from 2,500 + 500, to fit the script's time limit: the step is
# host-bound, 47-57 ms on the H100's host (PERF.md section 5)
SEGMENT_STEPS = 400
SEGMENT_FIRE = 500               # run_segment's default minimization
SEGMENT_RESUME_STEPS = 100
SEGMENT_REPORT = 100
BAROSTAT_INTERVAL = 25
PME_WATER_WARM_STEPS = 100       # phase 19: the water box, NPT + PME
PME_WATER_STEPS = 500            # cut from 1,000 to fit
PME_WATER_REPORT = 100
PME_WATER_FIRE = 100
# phase 20: run_segment on chignolin solvated in TIP4P-Ew, NPT + PME
TIP4P_FIRE = 300
TIP4P_STEPS = 400                # cut from 1,000 + 200 to fit
TIP4P_RESUME_STEPS = 100
TIP4P_REPORT = 50
# the solvation lattice, minimized, is ice-like: melting it takes up heat,
# and at 1/ps the thermostat had the second half at 0.94 of the target
# (a first call); 5/ps, the coupling of the JAX package's melt protocol
# (tests/unit/test_rdf.py), equilibrates within the segment
TIP4P_FRICTION = 5.0
# the same coupling where a run cut to fit starts from a minimum and its
# temperature is gated (phases 7, 13 and 18): the kinetic energy halves into
# the potential at once and 1/ps brings it back over ~1 ps an e-fold (phase
# 13 read 0.969-0.972 over 2-4 ps at 1/ps, PR 18); at 5/ps the gated window
# of the shorter runs is at temperature. The target, not the rate, is what
# the gates hold
SHORT_RUN_FRICTION = 5.0
# g(r) of the water oxygens: the first peak of TIP4P-Ew's O-O near 0.28 nm
RDF_PEAK_NM = (0.26, 0.30)
RDF_PEAK_MIN = 2.0
# phase 21: 10^3 TIP5P waters through the dense sweep, NVT then NVE
TIP5P_SIDE = 10
TIP5P_FIRE = 100
TIP5P_WARM_STEPS = 200
TIP5P_NVE_STEPS = 500             # cut from 1,000 to fit
TIP5P_REPORT = 50
SITE_ATOL_NM = 1e-6
SWEEP_REPLICAS = (8, 32, 128, 512)   # the per-step sweep of phases 2 and 8
# phase 24: the raw assembly through Protein.prepare and the CLI. Tolerances
# from a CPU run of the same preparation (numpy, the same code on the card's
# host): the ring closures repair places last read up to 0.6212 of r0 (TRP
# CZ2-CH2 at 0.053 nm in 17 of the 27 copies, 0.1325 nm in the other ten:
# translated copies of one input), every other rebuilt bond up to 0.048 (the
# loop's C-N splice); the gap closes to 0.0049 nm against 3 x tol_nm
PREP_TOL_NM = 0.005
PREP_RING_BOND_REL = 0.65
PREP_BOND_REL = 0.05
RING_CLOSURES = ({"CZ2", "CH2"}, {"CD2", "CE2"})
PHOSPHATE = ("P", "O1P", "O2P", "O3P")
CLI_STEPS = 1_000                # the CLI's protein REMD, 8 rungs 300-330 K, 4 fs
CLI_SEGMENT_STEPS = 200
# phase 25: a protein-DNA and a protein-RNA complex through row 1, R=8, 1 fs.
# The prepared chain and the built strand keep relaxing for picoseconds
# (examples/23_protein_dna_complex.py's 2,000 FIRE iterations release ~430
# kJ/mol more than 500; after 500, plain run_md on the CPU read 1.09-1.13 of
# the target over the second ps; after 2,000 and 4 ps, 0.95-1.02 by rung at
# 4-6 ps), so FIRE runs 2,000 iterations and the REMD equilibrates 4 ps
# before its 2,000 steps; the ladder's mean kinetic/target temperature over
# them within phase 7's band, each rung's within phase 17's
MD_RANKS = 2                     # phase 27: ranks on the one card (gloo)
MD_ALANINE_STEPS = 2_000
MD_PROTEIN_STEPS = 100
MD_WATER_SIDE = 24               # 24^3 waters = 41,472 atoms, box 7.54 nm: nx = 8 at 0.9 nm
MD_WATER_FIRE = 50               # FIRE iterations from the lattice
MD_WATER_STEPS = 20              # run_md through the slab launch
#: the tilt ratios bx / ax, cx / ax, cy / by of JAX's dry run
#: (``__graft_entry__.py``: tilt (0.45, 0.3, 0.4) on a 3.65 x 1.85 x 1.85 box)
MD_TILT_RATIOS = (0.45 / 3.65, 0.3 / 3.65, 0.4 / 1.85)
MD_DEEPTICA = (32, 200, 32)      # trajectories x frames x features
NB_STEPS = 400                   # phase 28: run_md_nb at JAX's test settings
NB_DT_PS = 0.002
NB_FRICTION = 1.0
NB_CUTOFF = 2.0
NB_SKIN = 0.2
NB_REBUILD = 20
NB_REPORT = 100
NB_WARM_STEPS = 300              # row 7 at SHORT_RUN_FRICTION before run_md_nb
NB_ROW7_STEPS = 100              # row 7 timed from run_md_nb's start state
NB_PARITY_REL = 1e-4             # nblist vs the cut pair path: energy, force / largest
NB_T_BAND = (0.95, 1.05)         # state's mid-step temperature over the last 200 steps
ROLLED_STEPS = 100
ROLLED_DT_PS = 0.004
NUCLEIC_REPLICAS = 8
NUCLEIC_DT_PS = 0.001
NUCLEIC_FIRE = 2_000
NUCLEIC_EQUILIBRATION = 4_000
NUCLEIC_STEPS = 2_000
NUCLEIC_T_MEAN_BAND = (0.95, 1.05)
NUCLEIC_T_BAND = (0.9, 1.1)
FUSED_KERNELS = ("fused_md_chunk_kernel", "fused_md_bias_kernel", "fused_remd_kernel",
                 "fused_remd_bias_kernel", "fused_md_chunk_single_kernel",
                 "fused_remd_single_kernel")
# ms of the kernels before their redesign at the same timed shapes: the
# one-thread-an-atom fused kernels, the row-owned dense Born and energy
# sweeps, the Newton Born and energy sweeps' block walk and the row-owned
# periodic and cell sweeps, copied from PERF.md section 6 (not measured by
# this script): printed on a line of their own beside the kernels line;
# the one-pass bonded kernel and the row-owned culled sweeps, a call and
# alone (``*_graph``: a CUDA graph of the calls), from
# scripts/time_port_kernels.py on their last commit; the fused kernels'
# row-owned step (``*_row_owned``: every ordered pair from its row team,
# this script's run on an H100 on the last commit before the pair items)
EARLIER_MS = {"fused_remd_row_owned": 13.17, "fused_md_chunk_row_owned": 0.9187,
              "fused_md_chunk_n138_row_owned": 5.861, "fused_md_bias_harmonic_row_owned": 6.942,
              "fused_md_bias_metadynamics_row_owned": 7.453,
              "fused_md_fused_metadynamics_row_owned": 7.514,
              "fused_md_chunk": 7.108, "fused_md_chunk_n138": 36.01,
              "fused_md_bias_harmonic": 37.38, "fused_md_bias_metadynamics": 37.83,
              "fused_md_fused_metadynamics": 38.77, "fused_remd": 73.14,
              "pair_born": 0.7112, "pair_energy": 0.6614,
              "pair_born_newton": 0.7583, "pair_energy_newton": 0.6720,
              "periodic_force": 0.1327, "cell_force": 0.1831, "cell_force_r4": 0.6593,
              "bonded": 0.0901, "bonded_graph": 0.0805,
              "pair_force_culled": 1.0637, "pair_force_culled_graph": 1.0627,
              "pair_born_culled": 1.0439, "pair_born_culled_graph": 1.0465,
              "pair_energy_culled": 0.9322, "pair_energy_culled_graph": 0.9268}
SHAPE_KEYS = ("cluster", "lanes", "team", "pairs", "threads", "staged", "slots_smem")

# Roofline constants of one H100 SXM: HBM bandwidth and the float32 rate
# outside the tensor cores (NVIDIA's data sheet), and the special-function
# rate: 132 SMs x 16 SFU results a clock at the 1,980 MHz boost clock
# (Hopper architecture white paper).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
# The bound of a GB pair sweep (rows 1-7 of PERF.md: the pair kernels, and
# the fused kernels' three sweeps a step, _md_bound) counts the least work
# of its function, not of a design: each unordered pair once, and with a
# cutoff only the pairs inside it (a pair outside needs no work but its
# test, which a design that does not visit it avoids). So a design that
# visits fewer pairs cannot lower the bound: the dense sweeps and the fused
# kernels count R N (N - 1) / 2 pairs, the culled and Newton sweeps half
# the ordered pairs inside the cutoff. A special function is one special-function result (the
# force sweeps take them so, csrc/gb_force.cuh): 1/r and r from one rsqrt;
# a per-atom factor (1/B) is staged, not counted a pair. Each unordered pair:
# - born (I_i and I_j): distance 9 (3 differences, r^2 5, + 1e-12), r from
#   1/r 1 [rsqrt]; the HCT value per direction 21 and its 1/2 and sum 2,
#   x 2; the neck value 9 [1/denom] and both sums 2: 67, 2. A direction's
#   HCT value (csrc/gb_force.cuh hct_value) is a series where it is far
#   (|sr_j / r| <= 0.3 and r - sr_j >= rho_i): t = sr_j / r and the
#   activity sum r + sr_j 2, the test's r - sr_j 1, t^2 1, eight terms 14,
#   t^3 / r times their sum 3: 21, no special function. A near direction
#   takes born_pair's form, 21 [1/L, 1/U, log]: BORN_NEAR_SFU more results,
#   counted on each run's positions (_pair_counts).
# - energy (the pair's energy, dE/dB both sides): distance 9 [rsqrt]; LJ +
#   Coulomb 15; exp argument 3 [exp]; f^2 3 [rsqrt]; the GB energy 4;
#   dE/dB 3 shared + 6 a side; the three sums 3: 52, 3.
# - force (dE/dr / r, both Born chain directions, csrc/gb_force.cuh
#   force_pair): distance 9 [rsqrt]; r and 1/r^2 2; LJ + Coulomb dE/dr 17;
#   GB f-function and its dE/dr 15 [exp, rsqrt]; the HCT derivative per
#   direction 34 [1/L, 1/U, log] and its 1/2 1, x 2; the neck derivative 14
#   [1/denom] and its two sums 2; the chain terms 4 and / r 1; F_i and F_j
#   9: 143, 10.
NEWTON_OPS = {"born": (67, 2), "energy": (52, 3), "force": (143, 10)}
BORN_NEAR_SFU = 3
# kernels whose registers and spills phase 1 reads and gates (no spill)
PAIR_PTXAS_KERNELS = ("pair_born_kernel", "pair_energy_kernel", "pair_force_kernel",
                      "newton_born_kernel", "newton_energy_kernel", "newton_force_kernel",
                      "pair_born_culled_kernel", "pair_energy_culled_kernel",
                      "pair_force_culled_kernel", "bonded_term_kernel", "bonded_atom_kernel")
PERIODIC_PTXAS_KERNELS = ("periodic_force_kernel", "cell_force_kernel", "periodic_slots_kernel",
                          "cell_pack_kernel")
# The bound of a periodic sweep (rows 8-9) counts the least work of its
# function, as the GB rows do: each unordered pair inside the cutoff once
# (counted on the run's positions by the kernels' own walk, _dense_walk and
# _cell_walk), its pair term from csrc/periodic_pair.cuh: (float32
# operations, special-function results) with shifted LJ and reaction field,
# and the extra of the switch and of the Ewald term (erfcf counted as a
# polynomial and one exponential). A candidate outside the cutoff needs no
# work but its test, which a design that does not visit it avoids, so
# candidates are not charged.
PERIODIC_PAIR_OPS = (53, 1)
# The bound of the bonded kernel (row 10) counts the least work of its
# function, as the pair rows do: each term once, its atoms' positions and
# its index and parameter rows in, the gradient and the energy out (the
# per-atom CSR and the slots are a design's, not charged). Float32
# operations and special-function results a term of csrc/bonded_terms.cuh
# bonded_term_all, a division one reciprocal and one product, sqrt, acos,
# atan2, sin and cos one result each (and acos, atan2, sin, cos ~10 more
# operations for their polynomials):
# - bond: d 3; r^2 + eps 6 [sqrt]; dr 1; k dr / r 2 [rcp]; two forces 6;
#   the energy 3: 21, 2.
# - angle: u, w 6; |u|^2, |w|^2 + eps 12 [2 sqrt]; nu, nw 6 [2 rcp]; cos 5,
#   clip 2; theta 8 [acos]; sin 3 [sqrt]; dE 2; the two end forces 30 [2
#   rcp]; the middle one 6; the energy 4: 84, 8.
# - torsion: b1-b3 9; m, n 18; |b2| 6 [sqrt]; |m|^2, |n|^2 12; m x n 9; y, x
#   11 [rcp]; phi 10 [atan2]; arg 2; dE 7 [sin]; s12, s32 13 [rcp]; d1, d4 11
#   [2 rcp]; the four forces 30; the energy 6 [cos]: 144, 8.
BONDED_OPS = {"bond": (21, 2), "angle": (84, 8), "torsion": (144, 8)}
PERIODIC_SWITCH_OPS = (20, 0)
PERIODIC_EWALD_OPS = (30, 2)


def _line(phase: str, numbers: dict) -> None:
    print(f"{phase}: {json.dumps(numbers)}", flush=True)


_T0 = time.perf_counter()
PHASE_S: dict = {}


def _timed(name: str, fn, *args):
    """``fn(*args)`` with its wall seconds (the card synchronised) kept in
    ``PHASE_S[name]`` and printed to standard error."""
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    now = time.perf_counter()
    PHASE_S[name] = now - t0
    print(f"{name}: {PHASE_S[name]:.1f} s, {now - _T0:.1f} s since the start",
          file=sys.stderr, flush=True)
    return out


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls (warm)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int, kernel: str) -> float:
    """Device milliseconds a call of ``fn()`` spends in CUDA kernels whose
    name holds ``kernel``, from ``torch.profiler`` over ``reps`` calls
    (warm)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if kernel in ev.key and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            total += getattr(ev, "self_device_time_total", 0.0)
    _check(total > 0.0, f"the profiler saw no device time of {kernel}")
    return total / reps / 1e3


def _graph_ms(fn, reps: int = 50) -> float:
    """Device milliseconds of ``fn()`` without the host: one replay of a
    CUDA graph that captured ``reps`` calls, over ``reps`` (the median of
    five replays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def _ladder(n: int = N_REPLICAS) -> torch.Tensor:
    from pmarlo_tpu_torch.remd.remd import RemdConfig

    lad = RemdConfig(n_replicas=n, t_min=300.0, t_max=450.0).ladder()
    return torch.as_tensor(lad, dtype=torch.float32, device="cuda")


def _reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from pmarlo_tpu_torch.md import (bonded_window, cell_force, fused_md, pair_force,
                                     periodic_force)

    fused_md.launches = 0
    for counts in (fused_md.variant_launches, pair_force.launches,
                   periodic_force.launches, cell_force.launches, bonded_window.launches):
        for k in counts:
            counts[k] = 0


def _counts() -> dict:
    from pmarlo_tpu_torch.md import (bonded_window, cell_force, fused_md, pair_force,
                                     periodic_force)

    return {"fused_md_chunk": fused_md.launches, **fused_md.variant_launches,
            **pair_force.launches, **periodic_force.launches, **cell_force.launches,
            **bonded_window.launches}


def _bound(flops: float, sfu: float, n_bytes: float) -> dict:
    """Least milliseconds the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rates."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(flops / FP32_FLOPS, sfu / SFU_OPS_PER_S) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _md_bound(R: int, N: int, n_force_evals: int, *, n_dih: int = 0, widths=(),
              n_hills: int = 0, frames: int = 0) -> dict:
    """Bound of a fused-MD launch: ``n_force_evals`` force evaluations of R
    replicas of N atoms, plus the CV bias (M dihedrals computed once and
    once more per role, the MLP forward and backward, the hills sum), state
    in and out once, the (N, N) tables once, ``frames`` frames out. A force
    evaluation is the three GB sweeps of NEWTON_OPS over the N (N - 1) / 2
    unordered pairs, each once: the least work of the function, as for the
    pair kernels (the fused kernels take every ordered pair, with IEEE
    special functions, which a bound does not count); the Born sweep at its
    far-pair count, the lower, since the positions move from step to step."""
    pairs = N * (N - 1) / 2
    flops = pairs * sum(f for f, _ in NEWTON_OPS.values())
    sfu = pairs * sum(t for _, t in NEWTON_OPS.values())
    if n_dih:
        mlp = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
        flops += 5 * n_dih * 150 + 4 * mlp + n_hills * 20
        sfu += 5 * n_dih * 4 + sum(widths[1:-1]) + n_hills
    n_bytes = 4 * (4 * R * N * 3 + R + 6 * N * N + 9 * N
                   + frames * R * (N * 3 + 2) + 3 * n_hills)
    return _bound(R * n_force_evals * flops, R * n_force_evals * sfu, n_bytes)


def _mb_velocities(system, temps: torch.Tensor, rng) -> torch.Tensor:
    """Maxwell-Boltzmann velocities (R, N, 3) from a numpy generator."""
    from pmarlo_tpu_torch.constants import BOLTZMANN_CONSTANT_KJ_PER_MOL

    kT = BOLTZMANN_CONSTANT_KJ_PER_MOL * temps.cpu().numpy()
    m = system.masses.cpu().numpy()
    z = rng.standard_normal((len(kT), system.n_atoms, 3))
    v = np.sqrt(kT[:, None, None] / m[None, :, None]) * z
    return torch.as_tensor(v, dtype=torch.float32, device="cuda")


def _ptxas(log: str, kernels) -> dict:
    """Registers and spill bytes ptxas reported for each of ``kernels``."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d([a-z_]+?_kernel)E", ln)
        if m:
            name = m.group(1) if m.group(1) in kernels else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
            name = None
    return out


def phase_build() -> dict:
    from pmarlo_tpu_torch import _kernels

    t0 = time.perf_counter()
    path = _kernels.build_library()
    secs = time.perf_counter() - t0
    log = _kernels.build_log()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    out = {"build_s": secs, "library": path.name,
           "fused_ptxas": _ptxas(log, FUSED_KERNELS),
           "pair_ptxas": _ptxas(log, PAIR_PTXAS_KERNELS),
           "periodic_ptxas": _ptxas(log, PERIODIC_PTXAS_KERNELS), "ptxas": ptxas}
    for key, names in (("fused_ptxas", FUSED_KERNELS), ("pair_ptxas", PAIR_PTXAS_KERNELS),
                       ("periodic_ptxas", PERIODIC_PTXAS_KERNELS)):
        found = out[key]
        _check(sorted(found) == sorted(names) and all(
            {"registers", "spill_stores", "spill_loads"} <= set(k) for k in found.values()),
            f"ptxas of {names}: {found}")
        _check(all(k["spill_stores"] == 0 and k["spill_loads"] == 0 for k in found.values()),
               f"kernels spill: {found}")
    _line("phase 1 build", out)
    return out


def _shape(chunk) -> dict:
    """The launch shape of ``chunk``'s last launch."""
    return {k: chunk.last_launch[k] for k in SHAPE_KEYS}


def _replica_sweep(system, x_min, seed: int) -> list:
    """us a step (100-step launches, friction 1/ps) at each of
    ``SWEEP_REPLICAS`` replicas, with the launch shape chosen."""
    from pmarlo_tpu_torch.md.fused_md import build_fused_chunk

    rows = []
    for R in SWEEP_REPLICAS:
        x, v, seeds, temps = _md_inputs(system, x_min, R, seed)
        chunk = build_fused_chunk(system, dt=DT_PS, friction=1.0, n_replicas=R)
        ms = _cuda_ms(lambda: chunk(x, v, seeds, temps, 100, 0), 3)
        rows.append({"replicas": R, "us_per_step": ms * 10.0, **_shape(chunk)})
    return rows


def _shape_sweep(chunk, x, v, seeds, temps) -> list:
    """[C, L, T, P, threads, staged, slots in shared memory, ms per 100
    steps, the chooser's cost] of every launch shape the kernel takes for
    ``chunk``'s system and replica count."""
    from pmarlo_tpu_torch.md.fused_md import launch_shapes, shape_cost

    rows = []
    n = chunk.system.n_atoms
    for shape in launch_shapes(n):
        ms = _cuda_ms(lambda: chunk._launch(x, v, seeds, temps, 100, 0, False, shape=shape), 3)
        last = chunk.last_launch
        rows.append([last[k] for k in ("cluster", "lanes", "team", "pairs", "threads", "staged",
                                       "slots_smem")] + [ms, shape_cost(n, shape)])
    return rows


def phase_kernel_vs_plain(system, x_min) -> dict:
    """Kernel against the plain twin on the same inputs (R=32)."""
    from pmarlo_tpu_torch.md import analytic
    from pmarlo_tpu_torch.md.fused_md import build_fused_chunk

    rng = np.random.default_rng(0)
    R = N_REPLICAS
    x = x_min[None] + torch.as_tensor(
        rng.normal(0.0, 0.005, (R, system.n_atoms, 3)), dtype=torch.float32,
        device="cuda",
    )
    temps = _ladder()
    seeds = torch.as_tensor(rng.integers(0, 2**31 - 1, R), dtype=torch.int32,
                            device="cuda")
    v = _mb_velocities(system, temps, rng)
    out = {}

    chunk0 = build_fused_chunk(system, dt=DT_PS, friction=0.0, n_replicas=R)
    ek, fk = chunk0.energy_and_forces(x)
    ep, fp = analytic.energy_and_forces(chunk0.dense, x)
    torch.cuda.synchronize()
    out["force_max_abs_err"] = float((fk - fp).abs().max())
    out["force_rel_err"] = out["force_max_abs_err"] / float(fp.abs().max())
    out["energy_rel_err"] = float((ek - ep).abs().max() / ep.abs().max())
    _check(out["force_rel_err"] <= 1e-4, f"kernel forces rel err {out['force_rel_err']}")
    _check(out["energy_rel_err"] <= 1e-4, f"kernel energy rel err {out['energy_rel_err']}")
    out["forces_ms"] = _cuda_ms(lambda: chunk0.energy_and_forces(x), 50)
    out["forces_plain_ms"] = _cuda_ms(lambda: analytic.energy_and_forces(chunk0.dense, x), 50)

    for friction in (0.0, 1.0):
        chunk = build_fused_chunk(system, dt=DT_PS, friction=friction, n_replicas=R)
        xk, vk, ek = chunk(x, v, seeds, temps, 100, 0)
        xp, vp, ep = chunk.reference(x, v, seeds, temps, 100, 0)
        torch.cuda.synchronize()
        # the kernel's energies against the twin's at the kernel's own final
        # positions; the two trajectories' energies also differ by the
        # ~1e-6 nm their float rounding has grown to (reported, not gated:
        # max |dx| gates the trajectories)
        e_at_xk, _ = analytic.energy_and_forces(chunk.dense, xk)
        tag = f"friction{friction:g}"
        out[f"{tag}_max_dx_nm"] = float((xk - xp).abs().max())
        out[f"{tag}_energy_rel_err"] = float((ek - e_at_xk).abs().max() / e_at_xk.abs().max())
        out[f"{tag}_traj_energy_rel_diff"] = float((ek - ep).abs().max() / ep.abs().max())
        _check(bool(torch.isfinite(xk).all()), f"{tag}: kernel positions finite")
        _check(out[f"{tag}_max_dx_nm"] <= 1e-3, f"{tag}: max |dx| {out[f'{tag}_max_dx_nm']}")
        _check(out[f"{tag}_energy_rel_err"] <= 1e-4,
               f"{tag}: energy rel err {out[f'{tag}_energy_rel_err']}")
    out["chunk100_ms"] = _cuda_ms(lambda: chunk(x, v, seeds, temps, 100, 0), 20)
    out["chunk100_shape"] = _shape(chunk)
    xa, va, ea = chunk(x, v, seeds, temps, 100, 0)
    xb, vb, eb = chunk(x, v, seeds, temps, 100, 0)
    out["bitwise_equal_launches"] = bool(
        torch.equal(xa, xb) and torch.equal(va, vb) and torch.equal(ea, eb))
    _check(out["bitwise_equal_launches"], "two launches of the chunk differ")
    out["chunk100_plain_ms"] = _cuda_ms(
        lambda: chunk.reference(x, v, seeds, temps, 100, 0), 3)
    out["replica_sweep"] = _replica_sweep(system, x_min, seed=2)
    out["shape_sweep_r32"] = _shape_sweep(chunk, x, v, seeds, temps)
    _line("phase 2 kernel", out)
    return out


def phase_thermostat(system, x_min) -> dict:
    """Kinetic temperature over 10,000 kernel steps at 1/ps."""
    from pmarlo_tpu_torch.md.fused_md import build_fused_chunk
    from pmarlo_tpu_torch.md.integrate import instantaneous_temperature

    rng = np.random.default_rng(1)
    R = N_REPLICAS
    temps = _ladder()
    chunk = build_fused_chunk(system, dt=DT_PS, friction=1.0, n_replicas=R)
    x = x_min[None].expand(R, -1, -1).contiguous()
    v = _mb_velocities(system, temps, rng)
    seeds = torch.as_tensor(rng.integers(0, 2**31 - 1, R), dtype=torch.int32,
                            device="cuda")
    ratios = []
    for w in range(100):
        x, v, _ = chunk(x, v, seeds, temps, 100, 100 * w)
        if w >= 10:         # the first 1,000 steps equilibrate
            # the state velocities are the post-O half-step velocities,
            # which folded BAOAB keeps at the target temperature
            ratios.append(instantaneous_temperature(system, v) / temps)
    per_rung = torch.stack(ratios).mean(0)
    ratio = float(per_rung.mean())
    out = {
        "steps": 10_000,
        "kinetic_over_target": ratio,
        "per_rung_min": float(per_rung.min()),
        "per_rung_max": float(per_rung.max()),
    }
    _check(bool(torch.isfinite(x).all()), "thermostat positions finite")
    _check(0.97 <= ratio <= 1.03, f"kinetic/target temperature {ratio}")
    _line("phase 3 thermostat", out)
    return out


def _phi_psi_quads(system) -> torch.Tensor:
    ai = system.atom_index
    quads = [
        [ai(1, "C"), ai(2, "N"), ai(2, "CA"), ai(2, "C")],    # phi
        [ai(2, "N"), ai(2, "CA"), ai(2, "C"), ai(3, "N")],    # psi
    ]
    return torch.as_tensor(quads, dtype=torch.int64, device="cuda")


def _synthetic_msm_shards():
    """bench.py bench_msm: 35 shards, ~13k frames, two 4-D blobs."""
    rng = np.random.default_rng(0)
    shards = []
    per = 13_000 // 35
    for _ in range(35):
        X = np.concatenate([
            rng.normal(-1, 0.3, (per // 2, 4)),
            rng.normal(1, 0.3, (per - per // 2, 4)),
        ]).astype(np.float32)
        rng.shuffle(X)
        shards.append({"features": X, "metadata": {"stride": 1}})
    return shards


def _msm_build(shards):
    from pmarlo_tpu_torch.analysis.discretize import discretize_dataset
    from pmarlo_tpu_torch.msm.free_energy import generate_2d_fes

    result = discretize_dataset(shards, n_states=50, lag=10, seed=0)
    pooled = np.concatenate([s["features"] for s in shards])
    generate_2d_fes(pooled[:, 0], pooled[:, 1], temperature_K=300.0, bins=32)
    return result


def phase_main_path(system, positions) -> dict:
    from pmarlo_tpu_torch.analysis.discretize import discretize_dataset
    from pmarlo_tpu_torch.md.forces import dihedral_angles
    from pmarlo_tpu_torch.msm.free_energy import generate_2d_fes
    from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange

    cfg = RemdConfig(
        n_replicas=N_REPLICAS, t_min=300.0, t_max=450.0,
        exchange_frequency=EXCHANGE_FREQUENCY,
        report_interval=EXCHANGE_FREQUENCY, dt_ps=DT_PS, seed=0,
    )
    remd = ReplicaExchange(system, positions, cfg, device="cuda", use_kernel=True)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = remd.run(N_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    n_launches = counts["fused_md_chunk"]
    out = {
        "launches": n_launches,
        "frames": list(res.positions.shape),
        "mean_acceptance": res.mean_acceptance,
        "remd_wall_s": wall,
    }
    _check(n_launches == N_STEPS // EXCHANGE_FREQUENCY,
           f"main path made {n_launches} kernel launches")
    _check(all(counts[k] == 0 for k in PAIR_KERNELS),
           f"alanine path launched pair kernels: {counts}")
    _check(bool(np.isfinite(res.positions).all()), "REMD frames finite")
    _check(bool(np.isfinite(res.potential_energy).all()), "REMD energies finite")
    _check(0.0 < res.mean_acceptance < 1.0, f"mean acceptance {res.mean_acceptance}")

    # phi/psi of the four coldest rungs -> shards -> MSM -> FES
    quads = _phi_psi_quads(system)
    frames = torch.as_tensor(res.positions[:, :4], device="cuda")  # (F, 4, N, 3)
    ang = dihedral_angles(frames, quads).cpu().numpy()             # (F, 4, 2)
    rung_shards = []
    for rung in range(4):
        a = ang[:, rung]
        X = np.concatenate([np.cos(a), np.sin(a)], axis=1).astype(np.float32)
        rung_shards.append({"features": X, "metadata": {"stride": 1}})
    msm = discretize_dataset(rung_shards, n_states=16, lag=2, seed=0)
    T = msm.transition_matrix
    _check(np.allclose(T.sum(1), 1.0, atol=1e-8), "MSM rows sum to 1")
    _check(all(((d >= 0) & (d < msm.n_states)).all() for d in msm.dtrajs),
           "MSM labels in range")
    fes = generate_2d_fes(ang[:, :4, 0].ravel(), ang[:, :4, 1].ravel(),
                          temperature_K=300.0, bins=32,
                          periodic=(True, True))
    finite = np.isfinite(fes.free_energy)
    _check(bool(finite.any()), "FES has finite bins")
    out.update({
        "msm_states": int(msm.n_states),
        "msm_active": int(len(msm.active_states)),
        "msm_counted_pairs": int(msm.counted_pairs),
        "fes_occupied_bin_fraction": float(fes.finite_fraction),
    })
    # the process's first build of the synthetic set: the cold time
    shards = _synthetic_msm_shards()
    t0 = time.perf_counter()
    synth = _msm_build(shards)
    torch.cuda.synchronize()
    out["msm_build_cold_s"] = time.perf_counter() - t0
    _check(synth.counted_pairs > 0, "synthetic MSM counted pairs")
    out["synthetic_msm_counted_pairs"] = int(synth.counted_pairs)
    _line("phase 4 main path", out)
    # handed on, not printed: phase 22 analyses these frames and this set
    out.update(remd=res, rung_features=[s["features"] for s in rung_shards], synthetic=synth)
    return out


def phase_times(system, positions, main: dict) -> dict:
    from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange

    sim_ns = N_STEPS * DT_PS * 1e-3 * N_REPLICAS
    out = {
        "kernel_remd_wall_s": main["remd_wall_s"],
        "kernel_ns_per_day_aggregate": sim_ns * 86_400.0 / main["remd_wall_s"],
    }
    cfg = RemdConfig(
        n_replicas=N_REPLICAS, t_min=300.0, t_max=450.0,
        exchange_frequency=EXCHANGE_FREQUENCY,
        report_interval=EXCHANGE_FREQUENCY, dt_ps=DT_PS, seed=0,
    )
    plain = ReplicaExchange(system, positions, cfg, device="cuda", use_kernel=False)
    plain.run(EXCHANGE_FREQUENCY)       # warm-up window
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain.run(PLAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["plain_remd_steps"] = PLAIN_STEPS
    out["plain_remd_wall_s"] = wall
    out["plain_ns_per_day_aggregate"] = (
        PLAIN_STEPS * DT_PS * 1e-3 * N_REPLICAS * 86_400.0 / wall
    )
    shards = _synthetic_msm_shards()
    out["msm_build_cold_s"] = main["msm_build_cold_s"]
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        _msm_build(shards)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    out["msm_build_warm_s"] = float(np.median(warm))
    _line("phase 5 times", out)
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def phase_pair(system, x_min) -> dict:
    """The three pair kernels against their plain twins, R=8, N=3,726."""
    from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn

    rng = np.random.default_rng(6)
    R = PROTEIN_REPLICAS
    x = x_min[None] + torch.as_tensor(
        rng.normal(0.0, 0.005, (R, system.n_atoms, 3)), dtype=torch.float32,
        device="cuda",
    )
    fn = build_pair_force_fn(system)
    Ip = fn.born_reference(x)
    Ik = fn.born(x)
    Ik2 = fn.born(x)
    B, dB = fn.born_radii(Ip)
    ep, dp = fn.energy_rows_reference(x, B)
    ek, dk = fn.energy_rows(x, B)
    ek2, dk2 = fn.energy_rows(x, B)
    _, c = fn.gb_terms(B, dB, dp)
    Fp = fn.pair_forces_reference(x, B, c)
    Fk = fn.pair_forces(x, B, c)
    Fk2 = fn.pair_forces(x, B, c)
    # the Newton kernels over the whole upper triangle (no cutoff: every
    # patch listed, every row near), as a point of comparison for the dense
    # kernels' block design
    newton = build_pair_force_fn(system, newton=True)
    Fn = newton.pair_forces(x, B, c)
    In = newton.born(x)
    en, dn = newton.energy_rows(x, B)
    enp, dnp = newton.energy_rows_reference(x, B)
    Ek, Gk = fn(x)
    Ep, Gp = fn.reference(x)
    # how close each float32 path comes to a float64 evaluation (exact ke
    # and gb_pref: the float32 path takes them rounded), and where the
    # kernels' distance from it comes from: their Born integrals, or their
    # energy rows, each with the rest of the evaluation plain
    fn64 = build_pair_force_fn(system, dtype=torch.float64)
    E64, G64 = fn64.reference(x.double())
    I64 = fn64.born_reference(x.double())
    E_bk, _ = fn._evaluate(x, fn.born, fn.energy_rows_reference, fn.pair_forces_reference,
                           fn.bonded_reference)
    E_ek, _ = fn._evaluate(x, fn.born_reference, fn.energy_rows, fn.pair_forces_reference,
                           fn.bonded_reference)
    pairs, near = _pair_counts(fn, x)
    torch.cuda.synchronize()
    out = {
        "atoms": system.n_atoms, "replicas": R, "band": fn.band_D,
        "born_max_abs_err": float((Ik - Ip).abs().max()),
        "born_rel_err": _rel(Ik, Ip),
        "e_rows_rel_err": _rel(ek, ep),
        "dEdB_max_abs_err": float((dk - dp).abs().max()),
        "dEdB_rel_err": _rel(dk, dp),
        "force_max_abs_err": float((Fk - Fp).abs().max()),
        "force_rel_err": _rel(Fk, Fp),
        "total_energy_rel_err": _rel(Ek, Ep),
        "total_force_rel_err": _rel(Gk, Gp),
        "energy_vs_float64": _rel(Ek.double(), E64),
        "plain_energy_vs_float64": _rel(Ep.double(), E64),
        "born_vs_float64": _rel(Ik.double(), I64),
        "plain_born_vs_float64": _rel(Ip.double(), I64),
        "born_kernel_energy_vs_float64": _rel(E_bk.double(), E64),
        "rows_kernel_energy_vs_float64": _rel(E_ek.double(), E64),
        "force_vs_float64": _rel(Gk.double(), G64),
        "plain_force_vs_float64": _rel(Gp.double(), G64),
        "born_two_launches_bitwise_equal": bool(torch.equal(Ik, Ik2)),
        "energy_two_launches_bitwise_equal": bool(torch.equal(ek, ek2) and torch.equal(dk, dk2)),
        "force_two_launches_bitwise_equal": bool(torch.equal(Fk, Fk2)),
        "newton_force_rel_err": _rel(Fn, Fp),
        "newton_born_rel_err": _rel(In, Ip),
        "newton_e_rows_rel_err": _rel(en, enp),
        "newton_dEdB_rel_err": _rel(dn, dnp),
        "born_pairs": pairs / 2, "born_near_directions": near,
    }
    for key in ("born_rel_err", "e_rows_rel_err", "dEdB_rel_err", "total_energy_rel_err",
                "newton_born_rel_err", "newton_e_rows_rel_err", "newton_dEdB_rel_err"):
        _check(out[key] <= 1e-5, f"{key} {out[key]}")
    for key in ("force_rel_err", "total_force_rel_err"):
        _check(out[key] <= 1e-4, f"{key} {out[key]}")
    _check(bool(torch.isfinite(Gk).all()), "pair forces finite")
    for sweep in ("born", "energy", "force"):
        _check(out[f"{sweep}_two_launches_bitwise_equal"], f"dense {sweep} kernel reproducible")
    _check(out["newton_force_rel_err"] <= 1e-4, f"newton_force_rel_err {out['newton_force_rel_err']}")
    _check(out["force_vs_float64"] <= FORCE_VS_FLOAT64_MAX,
           f"force_vs_float64 {out['force_vs_float64']}")
    _check(out["energy_vs_float64"] <= ENERGY_VS_FLOAT64_MAX,
           f"energy_vs_float64 {out['energy_vs_float64']}")
    out["born_ms"] = _cuda_ms(lambda: fn.born(x), 20)
    out["born_plain_ms"] = _cuda_ms(lambda: fn.born_reference(x), 3)
    out["energy_ms"] = _cuda_ms(lambda: fn.energy_rows(x, B), 20)
    out["energy_plain_ms"] = _cuda_ms(lambda: fn.energy_rows_reference(x, B), 3)
    out["force_ms"] = _cuda_ms(lambda: fn.pair_forces(x, B, c), 20)
    out["force_plain_ms"] = _cuda_ms(lambda: fn.pair_forces_reference(x, B, c), 3)
    out["newton_force_ms"] = _cuda_ms(lambda: newton.pair_forces(x, B, c), 20)
    out["newton_born_ms"] = _cuda_ms(lambda: newton.born(x), 20)
    out["newton_energy_ms"] = _cuda_ms(lambda: newton.energy_rows(x, B), 20)
    out["eval_ms"] = _cuda_ms(lambda: fn(x), 20)
    out["eval_plain_ms"] = _cuda_ms(lambda: fn.reference(x), 3)
    _line("phase 6 pair", out)
    return out


def phase_protein_remd() -> dict:
    """Path 1 of the protein slice through ``run_replica_exchange``."""
    from pmarlo_tpu_torch.data.chignolin import chignolin_assembly
    from pmarlo_tpu_torch.md.constraints import build_h_constraints, constraint_violation
    from pmarlo_tpu_torch.remd.remd import RemdConfig, run_replica_exchange

    cfg = RemdConfig(
        n_replicas=PROTEIN_REPLICAS, t_min=300.0, t_max=330.0,
        exchange_frequency=100, report_interval=50, dt_ps=PROTEIN_DT_PS, seed=0,
        friction_per_ps=SHORT_RUN_FRICTION,
    )
    structure = chignolin_assembly(PROTEIN_COPIES)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res, system = run_replica_exchange(
        structure, n_steps=PROTEIN_STEPS, config=cfg, device="cuda",
        use_kernel=True, constraints="hbonds", gb_model="gbn2",
    )
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = _counts()
    # one launch of each pair kernel per force evaluation: 500 FIRE
    # iterations + the final energy, one per MD step, one per frame
    evals = 501 + PROTEIN_STEPS + PROTEIN_STEPS // cfg.report_interval
    spec = build_h_constraints(system)
    frames = torch.as_tensor(res.positions, device="cuda")
    deviation = float(constraint_violation(spec, frames))
    # kinetic/target over the frames after the first picosecond
    warm = int(round(1.0 / (cfg.report_interval * cfg.dt_ps)))
    ratio = res.kinetic_temperature[warm:] / res.temperatures[None, :]
    sim_ns = PROTEIN_STEPS * cfg.dt_ps * 1e-3 * PROTEIN_REPLICAS
    out = {
        "atoms": system.n_atoms,
        "replicas": PROTEIN_REPLICAS,
        "steps": PROTEIN_STEPS,
        "dt_ps": cfg.dt_ps,
        "constraints": spec.n_constraints,
        "launches": {k: counts[k] for k in PAIR_KERNELS},
        "force_evaluations": evals,
        "fused_launches": counts["fused_md_chunk"],
        "total_wall_s": total,
        "run_wall_s": res.wall_seconds,
        "ns_per_day_aggregate": sim_ns * 86_400.0 / res.wall_seconds,
        "mean_acceptance": res.mean_acceptance,
        "pair_acceptance": [float(a) for a in res.acceptance_matrix],
        "kinetic_over_target": float(ratio.mean()),
        "kinetic_over_target_per_rung": [float(r) for r in ratio.mean(0)],
        "kinetic_over_target_by_frame": [
            float(r) for r in (res.kinetic_temperature / res.temperatures[None, :]).mean(1)],
        "max_constraint_deviation_nm": deviation,
        "frames": list(res.positions.shape),
        "frames_finite": bool(np.isfinite(res.positions).all()),
    }
    _check(all(counts[k] == evals for k in PAIR_KERNELS),
           f"pair launches {counts} for {evals} force evaluations")
    _check(counts["fused_md_chunk"] == 0, "the protein path launched the fused chunk")
    _check(out["frames_finite"], "protein REMD frames finite")
    _check(bool(np.isfinite(res.potential_energy).all()), "protein energies finite")
    _check(deviation <= 1e-4, f"constraint deviation {deviation} nm")
    _check(0.0 < res.mean_acceptance < 1.0, f"mean acceptance {res.mean_acceptance}")
    _check(0.95 <= out["kinetic_over_target"] <= 1.05,
           f"kinetic/target temperature {out['kinetic_over_target']}")
    _line("phase 7 protein remd", out)
    return out


def _chignolin() -> dict:
    """138-atom chignolin in GBn2 on the card: system, minimized positions,
    topology info and the phi/psi quadruples in feature order."""
    from pmarlo_tpu_torch.data.chignolin import chignolin_structure
    from pmarlo_tpu_torch.features import TopologyInfo, phi_psi_indices
    from pmarlo_tpu_torch.md.forcefield import build_system
    from pmarlo_tpu_torch.md.minimize import minimize_energy
    from pmarlo_tpu_torch.md.topology import build_topology

    structure = chignolin_structure()
    system, positions = build_system(structure, gb_model="gbn2", device="cuda")
    _check(system.device.type == "cuda", "build_system(device='cuda') is on the card")
    info = TopologyInfo.from_topology(build_topology(structure))
    phi, psi, _ = phi_psi_indices(info.atom_names, info.residue_ids, info.chain_ids)
    x_min, _ = minimize_energy(system, positions)
    return {"system": system, "positions": positions, "x_min": x_min, "info": info,
            "quads": np.concatenate([phi, psi], axis=0)}


def _random_model(n_dihedrals: int, seed: int):
    """A DeepTICA model of default width with random weights, scaler and
    whitening, made with numpy from ``seed``."""
    from pmarlo_tpu_torch.ml.deeptica import DeepTICAConfig, deeptica_from_numpy

    rng = np.random.default_rng(seed)
    cfg = DeepTICAConfig()
    k = 2 * n_dihedrals
    sizes = [k, *cfg.hidden, cfg.n_out]
    params = [{"w": rng.normal(0.0, np.sqrt(2.0 / (a + b)), (a, b)).astype(np.float32),
               "b": rng.normal(0.0, 0.1, b).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    whitening = {"mean": rng.normal(0.0, 0.1, cfg.n_out).astype(np.float32),
                 "transform": rng.normal(0.0, 1.0, (cfg.n_out, cfg.n_out)).astype(np.float32)}
    return deeptica_from_numpy(
        cfg, params, rng.normal(0.0, 0.3, k).astype(np.float32),
        rng.uniform(0.5, 1.0, k).astype(np.float32), whitening, device="cuda")


def _md_inputs(system, x_min, R: int, seed: int):
    rng = np.random.default_rng(seed)
    x = x_min[None] + torch.as_tensor(
        rng.normal(0.0, 0.005, (R, system.n_atoms, 3)), dtype=torch.float32,
        device="cuda")
    temps = _ladder(R)
    seeds = torch.as_tensor(rng.integers(0, 2**31 - 1, R), dtype=torch.int32,
                            device="cuda")
    return x, _mb_velocities(system, temps, rng), seeds, temps


def phase_bias(cx: dict, alanine, alanine_x_min) -> dict:
    """The in-kernel CV bias against its plain version and autograd."""
    from pmarlo_tpu_torch.bias import (
        HarmonicExpansionBias, MetadynamicsBias, make_cv_bias_fn)
    from pmarlo_tpu_torch.bias.harmonic import make_feature_cv_fn, make_phi_psi_feature_fn
    from pmarlo_tpu_torch.bias.metadynamics import metad_state_from_numpy
    from pmarlo_tpu_torch.md import fused_md
    from pmarlo_tpu_torch.md.fused_md import build_fused_chunk
    from pmarlo_tpu_torch.md.integrate import bias_energy_and_forces

    system, info, quads = cx["system"], cx["info"], cx["quads"]
    R, N, M = N_REPLICAS, system.n_atoms, len(quads)
    model = _random_model(M, seed=8)
    x, v, seeds, temps = _md_inputs(system, cx["x_min"], R, seed=8)
    strength = 2.0
    rng = np.random.default_rng(88)
    out = {"atoms": N, "replicas": R, "dihedrals": M,
           "widths": [2 * M, *model.config.hidden, model.config.n_out]}

    unbiased = build_fused_chunk(system, dt=DT_PS, friction=1.0, n_replicas=R)
    e0, f0 = unbiased.energy_and_forces(x)
    cv_fn = make_feature_cv_fn(
        make_phi_psi_feature_fn(info.atom_names, info.residue_ids,
                                chain_ids=info.chain_ids),
        model.as_function())
    mtd = MetadynamicsBias(sigma=MTD_SIGMA, height=1.0)
    # a ledger of 1,000 hills scattered around the replicas' own CVs
    with torch.no_grad():
        cv0 = cv_fn(x).cpu().numpy()
    centers = np.zeros((mtd.max_hills, 2), np.float32)
    heights = np.zeros(mtd.max_hills, np.float32)
    centers[:N_HILLS_CHECK] = (cv0[rng.integers(0, R, N_HILLS_CHECK)]
                               + rng.normal(0.0, 0.5, (N_HILLS_CHECK, 2)))
    heights[:N_HILLS_CHECK] = rng.uniform(0.1, 1.0, N_HILLS_CHECK)
    hills = metad_state_from_numpy(centers, heights, N_HILLS_CHECK, device="cuda")

    chunks = {}
    for kind in ("harmonic", "metadynamics"):
        ledger = hills if kind == "metadynamics" else None
        kw = dict(bias_model=model, bias_quads=quads, bias_strength=strength,
                  bias_kind=kind, mtd_sigma=MTD_SIGMA if ledger is not None else None)
        chunk = chunks[kind] = build_fused_chunk(
            system, dt=DT_PS, friction=1.0, n_replicas=R, **kw)
        ek, fk = chunk.energy_and_forces(x, ledger)
        ep, fp = chunk._force_fn(ledger)(x)
        # autograd of bias/ composed with ml/: the bias alone
        bias_fn = (make_cv_bias_fn(cv_fn, HarmonicExpansionBias(strength))
                   if ledger is None else mtd.bias_fn(ledger, cv_fn))
        ea, fa = bias_energy_and_forces(bias_fn, x)
        eb, fb = chunk.bias.energy_and_forces(x, ledger)
        torch.cuda.synchronize()
        fmax = float(fp.abs().max())
        tag = kind
        out[f"{tag}_force_max_abs_err"] = float((fk - fp).abs().max())
        out[f"{tag}_force_rel_err"] = out[f"{tag}_force_max_abs_err"] / fmax
        out[f"{tag}_energy_rel_err"] = float((ek - ep).abs().max() / ep.abs().max())
        out[f"{tag}_bias_energy_max"] = float(eb.abs().max())
        out[f"{tag}_bias_force_max"] = float(fb.abs().max())
        # the kernel's bias share (biased minus unbiased launch) and the
        # plain version's hand-written gradient, both against autograd
        out[f"{tag}_kernel_vs_autograd_force_rel"] = float(
            ((fk - f0) - fa).abs().max()) / fmax
        out[f"{tag}_plain_vs_autograd_force_rel"] = float((fb - fa).abs().max()) / fmax
        out[f"{tag}_kernel_vs_autograd_energy_rel"] = float(
            ((ek - e0) - ea).abs().max() / ep.abs().max())
        out[f"{tag}_plain_vs_autograd_energy_rel"] = float(
            (eb - ea).abs().max() / ea.abs().max())
        _check(out[f"{tag}_bias_force_max"] > 1.0, f"{tag}: the bias pushes")
        for key in ("force_rel_err", "kernel_vs_autograd_force_rel",
                    "plain_vs_autograd_force_rel"):
            _check(out[f"{tag}_{key}"] <= 1e-4, f"{tag} {key} {out[f'{tag}_{key}']}")
        for key in ("energy_rel_err", "kernel_vs_autograd_energy_rel",
                    "plain_vs_autograd_energy_rel"):
            _check(out[f"{tag}_{key}"] <= 1e-5, f"{tag} {key} {out[f'{tag}_{key}']}")
        for friction in (0.0, 1.0):
            c = build_fused_chunk(system, dt=DT_PS, friction=friction, n_replicas=R, **kw)
            xk, _, ek = c(x, v, seeds, temps, 100, 0, hills=ledger)
            xp, _, _ = c.reference(x, v, seeds, temps, 100, 0, hills=ledger)
            torch.cuda.synchronize()
            key = f"{tag}_friction{friction:g}_max_dx_nm"
            out[key] = float((xk - xp).abs().max())
            _check(bool(torch.isfinite(xk).all()), f"{key}: finite")
            _check(out[key] <= 1e-3, f"{key} {out[key]}")
        out[f"{tag}_chunk100_ms"] = _cuda_ms(
            lambda: chunk(x, v, seeds, temps, 100, 0, hills=ledger), 10)
        out[f"{tag}_chunk100_shape"] = _shape(chunk)
        xa, _, ea = chunk(x, v, seeds, temps, 100, 0, hills=ledger)
        xb, _, eb = chunk(x, v, seeds, temps, 100, 0, hills=ledger)
        _check(bool(torch.equal(xa, xb) and torch.equal(ea, eb)),
               f"{tag}: two launches of the biased chunk differ")
        out[f"{tag}_chunk100_plain_ms"] = _cuda_ms(
            lambda: chunk.reference(x, v, seeds, temps, 100, 0, hills=ledger), 1)
    out["unbiased_chunk100_ms"] = _cuda_ms(lambda: unbiased(x, v, seeds, temps, 100, 0), 10)
    out["unbiased_chunk100_shape"] = _shape(unbiased)
    out["replica_sweep"] = _replica_sweep(system, cx["x_min"], seed=12)
    out["shape_sweep_r32"] = _shape_sweep(unbiased, x, v, seeds, temps)

    # the same three at N = 22 (alanine dipeptide, 2 dihedrals, default width)
    aq = _phi_psi_quads(alanine).cpu().numpy()
    am = _random_model(len(aq), seed=9)
    ax, av, aseeds, atemps = _md_inputs(alanine, alanine_x_min, R, seed=9)
    a0 = build_fused_chunk(alanine, dt=DT_PS, friction=1.0, n_replicas=R)
    a1 = build_fused_chunk(alanine, dt=DT_PS, friction=1.0, n_replicas=R,
                           bias_model=am, bias_quads=aq, bias_strength=strength)
    out["alanine_unbiased_chunk100_ms"] = _cuda_ms(
        lambda: a0(ax, av, aseeds, atemps, 100, 0), 20)
    out["alanine_harmonic_chunk100_ms"] = _cuda_ms(
        lambda: a1(ax, av, aseeds, atemps, 100, 0), 20)

    # one grid barrier: R CTAs of the chignolin block size, 0 and 10,000 barriers
    threads = 32
    while threads < N:
        threads *= 2
    n_bar = 10_000
    t_none = _cuda_ms(lambda: fused_md.grid_barrier_probe(R, threads, 0), 10)
    t_bar = _cuda_ms(lambda: fused_md.grid_barrier_probe(R, threads, n_bar), 10)
    out["grid_barrier_us"] = (t_bar - t_none) * 1e3 / n_bar
    out["cooperative_launch_ms"] = t_none
    # the same in clusters of 4 CTAs: a cooperative launch that is also a
    # cluster launch (the fused metadynamics and REMD kernels' shape at N=138)
    t_none = _cuda_ms(lambda: fused_md.grid_barrier_probe(4 * R, threads, 0, cluster=4), 10)
    t_bar = _cuda_ms(lambda: fused_md.grid_barrier_probe(4 * R, threads, n_bar, cluster=4), 10)
    out["grid_barrier_cluster4_us"] = (t_bar - t_none) * 1e3 / n_bar
    _line("phase 8 bias kernel", out)
    out["model"] = model
    out["hills"] = hills
    return out


def _remd_config(seed: int):
    from pmarlo_tpu_torch.remd.remd import RemdConfig

    return RemdConfig(
        n_replicas=N_REPLICAS, t_min=300.0, t_max=450.0,
        exchange_frequency=EXCHANGE_FREQUENCY, report_interval=CV_REPORT,
        dt_ps=DT_PS, seed=seed,
    )


def _kinetic_ratio(res, cfg) -> float:
    """Kinetic over target temperature of the frames after the first 2 ps."""
    warm = int(round(2.0 / (cfg.report_interval * cfg.dt_ps)))
    return float((res.kinetic_temperature[warm:] / res.temperatures[None, :]).mean())


def _fused_remd_vs_plain(tag: str, remd) -> dict:
    """The whole-run kernel against the plain version (the chunk's twin and
    ``_attempt_swaps`` in a loop): ``PLAIN_LAUNCHES`` launches in a row,
    each compared with the plain version run from the very state the
    launch starts from (the trajectories are chaotic: their ~1e-6 nm of
    rounding grows about tenfold a window, so a comparison is restarted
    before it passes the tolerance). The launches of 2 windows hold the
    swap and the rung carry-over inside a launch against the plain
    version, the later ones start from permuted rungs and an advanced
    attempt counter, and the closing launch of 1 window gates the state
    after the swap tightly: velocities rescaled by ``sqrt(T_new / T_old)``
    (leaving the rescale out would move them by ~2e-2 nm/ps).

    A Metropolis decision whose margin ``|log u - log_acc|`` is no more
    than 10 times what the two sides' energies differ by in ``log_acc``
    lies within rounding of its threshold and may fall differently, after
    which the rungs hold different walkers: it fails the run rather than
    being skipped (the seeds are fixed; the smallest margin is reported)."""
    from pmarlo_tpu_torch.constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
    from pmarlo_tpu_torch.remd.remd import swap_uniforms

    cfg, R = remd.config, remd.n_replicas
    fpc = EXCHANGE_FREQUENCY // CV_REPORT
    betas = 1.0 / (BOLTZMANN_CONSTANT_KJ_PER_MOL * remd.ladder.double().cpu().numpy())
    pre = f"{tag}_vs_plain"
    out = {f"{pre}_windows": list(PLAIN_LAUNCHES)}
    rows = {k: [] for k in ("min_margin", "swaps", "frames_max_dx_nm", "energy_rel_err",
                            "final_max_dx_nm", "final_max_dv_nm_per_ps")}
    for n_windows in PLAIN_LAUNCHES:
        done = remd._attempts_done
        ref = remd._run_fused_reference(n_windows, fpc)
        _reset_counts()
        res = remd.run_fused(n_windows * EXCHANGE_FREQUENCY)
        torch.cuda.synchronize()
        _check(_counts()["fused_remd"] == 1, f"{tag}: the kernel was launched")
        ref_e = ref.frame_energy.cpu().numpy()
        ref_ids = ref.ids_hist.cpu().numpy()
        margins = []
        for a in range(n_windows):
            left = np.arange(a % 2, R - 1, 2)
            log_u = np.log(swap_uniforms(cfg.seed, done + a, R, "cpu").double().numpy()[left])
            last = (a + 1) * fpc - 1
            log_acc = [(betas[left] - betas[left + 1]) * (e[last, left] - e[last, left + 1])
                       for e in (ref_e.astype(np.float64),
                                 res.potential_energy.astype(np.float64))]
            margin = np.abs(log_u - log_acc[0])
            margins.append(float(margin.min()))
            _check(bool((margin > 10.0 * np.abs(log_acc[1] - log_acc[0]) + 1e-6).all()),
                   f"{tag}: a swap decision of attempt {done + a} lies within rounding "
                   "of its threshold")
        rows["min_margin"].append(min(margins))
        rows["swaps"].append(int((ref_ids[1:] != ref_ids[:-1]).sum() // 2))
        rows["frames_max_dx_nm"].append(
            float(np.abs(res.positions - ref.frames.cpu().numpy()).max()))
        rows["energy_rel_err"].append(
            float(np.abs(res.potential_energy - ref_e).max() / np.abs(ref_e).max()))
        rows["final_max_dx_nm"].append(
            float((remd.state.positions - ref.positions).abs().max()))
        rows["final_max_dv_nm_per_ps"].append(
            float((remd.state.velocities - ref.velocities).abs().max()))
        _check(np.array_equal(res.replica_ids, ref_ids), f"{tag}: kernel vs plain ids_hist")
        _check(bool((remd.state.seeds == ref.seeds).all()), f"{tag}: kernel vs plain seeds")
        # every launch swaps, and a 2-window launch swaps before its second window
        _check(bool((ref_ids[1] != ref_ids[0]).any()), f"{tag}: a swap in the first window")
    out.update({f"{pre}_{k}": v for k, v in rows.items()})
    _line(f"phase 9 {tag} kernel vs plain", out)
    _check(max(rows["frames_max_dx_nm"]) <= 1e-3 and max(rows["final_max_dx_nm"]) <= 1e-3,
           f"{tag}: kernel vs plain frames")
    _check(max(rows["energy_rel_err"]) <= 1e-4, f"{tag}: kernel vs plain energies")
    _check(PLAIN_LAUNCHES[-1] == 1 and rows["final_max_dv_nm_per_ps"][-1] <= 1e-3,
           f"{tag}: velocities after the swap")
    out[f"{pre}_frames_max_dx_nm"] = max(rows["frames_max_dx_nm"])
    return out


def phase_fused_remd(cx: dict, model) -> dict:
    """``run_fused`` against the windowed kernel path, then at full size."""
    from pmarlo_tpu_torch.remd.remd import ReplicaExchange

    system, x_min, quads = cx["system"], cx["x_min"], cx["quads"]
    cfg = _remd_config(seed=9)
    out = {"atoms": system.n_atoms, "replicas": N_REPLICAS}
    for tag, kb in (("unbiased", None),
                    ("biased", {"model": model, "quads": quads, "strength": 2.0})):
        def make(use_kernel=True):
            return ReplicaExchange(system, x_min, cfg, device="cuda", minimize=False,
                                   use_kernel=use_kernel, kernel_bias=kb)

        # --- window for window over 10 windows, same start and seeds ---
        fused, windowed = make(), make()
        n_short = 10 * EXCHANGE_FREQUENCY
        _reset_counts()
        rf = fused.run_fused(n_short)
        torch.cuda.synchronize()
        _check(_counts()["fused_remd"] == 1, f"{tag}: run_fused made one launch")
        rw = windowed.run(n_short)
        torch.cuda.synchronize()
        _check(np.array_equal(rf.replica_ids, rw.replica_ids), f"{tag}: ids_hist equal")
        _check(np.allclose(rf.acceptance_matrix, rw.acceptance_matrix, equal_nan=True),
               f"{tag}: accept equal")
        out[f"{tag}_frames_max_dx_nm"] = float(np.abs(rf.positions - rw.positions).max())
        out[f"{tag}_frame_energy_rel_err"] = float(
            np.abs(rf.potential_energy - rw.potential_energy).max()
            / np.abs(rw.potential_energy).max())
        out[f"{tag}_state_max_dx_nm"] = float(
            (fused.state.positions - windowed.state.positions).abs().max())
        out[f"{tag}_swaps_accepted_in_10_windows"] = int(
            (rf.replica_ids[1:] != rf.replica_ids[:-1]).sum() // 2)
        _check(out[f"{tag}_frames_max_dx_nm"] <= 1e-3, f"{tag}: frames agree")
        _check(out[f"{tag}_state_max_dx_nm"] <= 1e-3, f"{tag}: final state agrees")
        _check(out[f"{tag}_frame_energy_rel_err"] <= 1e-4, f"{tag}: frame energies agree")
        _check(bool((fused.state.seeds == windowed.state.seeds).all()),
               f"{tag}: seeds moved alike")

        # --- full size: both continue from where the short runs ended ---
        _reset_counts()
        t0 = time.perf_counter()
        rf = fused.run_fused(CV_FUSED_STEPS)
        torch.cuda.synchronize()
        wall_f = time.perf_counter() - t0
        counts = _counts()
        t0 = time.perf_counter()
        rw = windowed.run(CV_FUSED_STEPS)
        torch.cuda.synchronize()
        wall_w = time.perf_counter() - t0
        sim_ns = CV_FUSED_STEPS * DT_PS * 1e-3 * N_REPLICAS
        ratio = _kinetic_ratio(rf, cfg)
        out.update({
            f"{tag}_launches": counts["fused_remd"],
            f"{tag}_fused_wall_s": wall_f,
            f"{tag}_windowed_wall_s": wall_w,
            f"{tag}_fused_ns_per_day": sim_ns * 86_400.0 / wall_f,
            f"{tag}_windowed_ns_per_day": sim_ns * 86_400.0 / wall_w,
            f"{tag}_mean_acceptance": rf.mean_acceptance,
            f"{tag}_windowed_mean_acceptance": rw.mean_acceptance,
            f"{tag}_kinetic_over_target": ratio,
            f"{tag}_windowed_kinetic_over_target": _kinetic_ratio(rw, cfg),
            f"{tag}_frames": list(rf.positions.shape),
            f"{tag}_ids_equal_full_run": bool(np.array_equal(rf.replica_ids, rw.replica_ids)),
        })
        _check(counts["fused_remd"] == 1 and counts["fused_md_chunk"] == 0
               and counts["bias_harmonic"] == 0, f"{tag}: one launch, got {counts}")
        _check(bool(np.isfinite(rf.positions).all()), f"{tag}: frames finite")
        _check(bool(np.isfinite(rf.potential_energy).all()), f"{tag}: energies finite")
        _check(0.0 < rf.mean_acceptance < 1.0, f"{tag}: acceptance {rf.mean_acceptance}")
        _check(0.97 <= ratio <= 1.03, f"{tag}: kinetic/target {ratio}")
        _check(fused.state.positions.is_cuda, f"{tag}: state on the card")

        out.update(_fused_remd_vs_plain(tag, make()))

    # the unbiased kernel and its plain version, timed on 2 windows
    n_timed = 2 * EXCHANGE_FREQUENCY
    out["timed_steps"] = n_timed
    r = ReplicaExchange(system, x_min, cfg, device="cuda", minimize=False)
    fpc = EXCHANGE_FREQUENCY // CV_REPORT
    out["fused_remd_ms"] = _cuda_ms(lambda: r.run_fused(n_timed), 5)
    # the kernel alone: its device time beside the call's (host work in the call)
    out["fused_remd_device_ms"] = _device_ms(lambda: r.run_fused(n_timed), 5, "fused_remd")
    out["fused_remd_shape"] = _shape(r._chunk)
    out["fused_remd_plain_ms"] = _cuda_ms(lambda: r._run_fused_reference(2, fpc), 1)
    _line("phase 9 fused remd", out)
    return out


def phase_learned_cv(cx: dict) -> dict:
    """REMD -> features -> DeepTICA -> biased REMD -> fused metadynamics
    -> sampling under the ledger -> reweighted FES, on the card."""
    from pmarlo_tpu_torch.bias import MetadynamicsBias
    from pmarlo_tpu_torch.features import featurize_trajectory
    from pmarlo_tpu_torch.md.enhanced_sampling import run_fused_metadynamics
    from pmarlo_tpu_torch.md.fused_md import build_fused_chunk
    from pmarlo_tpu_torch.ml import DeepTICAConfig, train_deeptica
    from pmarlo_tpu_torch.msm.free_energy import generate_2d_fes
    from pmarlo_tpu_torch.remd.remd import ReplicaExchange

    system, positions, info, quads = (cx[k] for k in ("system", "positions", "info", "quads"))
    R = N_REPLICAS
    cfg = _remd_config(seed=10)
    out = {"atoms": system.n_atoms, "replicas": R}
    torch.cuda.synchronize()
    _reset_counts()

    # 1. unbiased REMD, one kernel launch a frame
    remd = ReplicaExchange(system, positions, cfg, device="cuda", use_kernel=True)
    res = remd.run(CV_STEPS)
    out["remd_wall_s"] = res.wall_seconds
    out["remd_mean_acceptance"] = res.mean_acceptance

    # 2. cos/sin of phi/psi along every walker's continuous trajectory (a
    # rung's trajectory changes walker at every accepted swap, which
    # breaks the time correlation the training looks for)
    feats = []
    for walker in range(R):
        traj = torch.as_tensor(res.replica_trajectory(walker), device="cuda")
        X, _ = featurize_trajectory(traj, "phi_psi", info, cos_sin_expand=True)
        feats.append(X)
    _check(feats[0].is_cuda and feats[0].shape == (res.positions.shape[0], 2 * len(quads)),
           f"features on the card, shape {tuple(feats[0].shape)}")
    out["features"] = list(feats[0].shape)

    # 3. DeepTICA at its defaults
    t0 = time.perf_counter()
    model = train_deeptica(feats, DeepTICAConfig(), device="cuda")
    torch.cuda.synchronize()
    hist = model.training_history
    out.update({
        "train_s": time.perf_counter() - t0,
        "epochs": len(hist["epochs"]),
        "vamp2_before": hist["vamp2_before"],
        "vamp2_after": hist["vamp2_after"],
        "first_val_vamp2": hist["epochs"][0]["val_vamp2"],
        "best_val_vamp2": hist["best"]["val_vamp2"],
        "best_epoch": hist["best"]["epoch"],
    })
    _check(model.device.type == "cuda", "the trained model lies on the card")
    # vamp2_before sums the modes of all 32 scaled features and vamp2_after
    # those of the 2 CVs, so the two are reported, not compared; what the
    # training must do is raise the 2-CV validation score
    _check(np.isfinite(hist["vamp2_before"]) and 0.0 < hist["vamp2_after"] <= 2.0 + 1e-3,
           f"VAMP-2 {hist['vamp2_before']} -> {hist['vamp2_after']}")
    _check(out["best_val_vamp2"] > out["first_val_vamp2"],
           f"validation VAMP-2 {out['first_val_vamp2']} -> {out['best_val_vamp2']}")

    # 4. the CV back in the MD kernel: biased windows, then the whole run fused
    biased = ReplicaExchange(system, positions, cfg, device="cuda", use_kernel=True,
                             kernel_bias={"model": model, "quads": quads, "strength": 1.0})
    rb = biased.run(CV_BIASED_STEPS)
    rfused = biased.run_fused(CV_FUSED_STEPS)
    out["biased_windows_wall_s"] = rb.wall_seconds
    out["biased_fused_wall_s"] = rfused.wall_seconds
    out["biased_fused_mean_acceptance"] = rfused.mean_acceptance
    out["biased_fused_kinetic_over_target"] = _kinetic_ratio(rfused, cfg)
    _check(bool(np.isfinite(rfused.positions).all()), "biased fused frames finite")
    _check(0.0 < rfused.mean_acceptance < 1.0,
           f"biased fused acceptance {rfused.mean_acceptance}")

    # 5. well-tempered metadynamics on the two CVs, deposits inside the launch
    mtd = MetadynamicsBias(sigma=MTD_SIGMA, height=1.2, bias_factor=10.0)
    t0 = time.perf_counter()
    md = run_fused_metadynamics(
        system, cx["x_min"], cv_model=model, cv_quads=quads, mtd=mtd,
        n_steps=MTD_STEPS, deposit_interval=MTD_INTERVAL, n_replicas=R, device="cuda")
    torch.cuda.synchronize()
    out["mtd_wall_s"] = time.perf_counter() - t0
    hills = md["hills"]
    n_hills = int(hills.n_hills)
    hh = hills.heights[:n_hills]
    out.update({"mtd_hills": n_hills, "mtd_height_min": float(hh.min()),
                "mtd_height_max": float(hh.max())})
    _check(hills.centers.is_cuda and md["positions"].is_cuda, "metadynamics on the card")
    _check(n_hills == md["n_windows"] * R == (MTD_STEPS // MTD_INTERVAL) * R,
           f"{n_hills} hills")
    _check(bool(((hh > 0.0) & (hh <= mtd.height)).all()), "well-tempered heights in (0, h]")
    _check(bool(torch.isfinite(hills.centers[:n_hills]).all()), "hill centers finite")
    _check(bool(torch.isfinite(md["positions"]).all()), "metadynamics positions finite")

    # 6. sampling under the final ledger, then the reweighted FES
    sampler = build_fused_chunk(
        system, dt=DT_PS, friction=1.0, n_replicas=R, bias_model=model,
        bias_quads=quads, bias_kind="metadynamics", mtd_sigma=MTD_SIGMA)
    x, v = md["positions"], md["velocities"]
    seeds = torch.arange(R, dtype=torch.int32, device="cuda")
    temps = torch.full((R,), 300.0, device="cuda")
    cvs = []
    for f in range(LEDGER_FRAMES):
        x, v, _ = sampler(x, v, seeds, temps, CV_REPORT, MTD_STEPS + f * CV_REPORT,
                          hills=hills)
        cvs.append(sampler.bias.cv(x))
    cvs = torch.cat(cvs).cpu().numpy()                                 # (frames * R, 2)
    weights = mtd.reweighting_factors(hills, cvs)
    fes = generate_2d_fes(cvs[:, 0], cvs[:, 1], temperature_K=300.0, bins=24,
                          weights=weights)
    torch.cuda.synchronize()
    counts = _counts()
    out["launches"] = {k: counts[k] for k in ("fused_md_chunk", *BIAS_VARIANTS)}
    out["fes_occupied_bin_fraction"] = float(fes.finite_fraction)
    _check(bool(np.isfinite(weights).all()) and float(weights.max()) > 0.0,
           "reweighting factors finite")
    _check(bool(np.isfinite(fes.free_energy).any()), "reweighted FES has finite bins")
    expected = {
        "fused_md_chunk": CV_STEPS // CV_REPORT,
        "bias_harmonic": CV_BIASED_STEPS // CV_REPORT,
        "fused_remd": 1,
        "fused_metadynamics": 1,
        "bias_metadynamics": LEDGER_FRAMES,
    }
    _check(out["launches"] == expected, f"launches {out['launches']}, expected {expected}")
    _check(all(counts[k] == 0 for k in PAIR_KERNELS), "no pair kernel on this path")

    # the ledger of a short fused run (R = 32, 2 windows of 50 steps)
    # against the plain version's, from the long run's ledger, so that each
    # of the 64 deposits sums 320 hills and more; then both timed
    interval, windows = 50, 2
    n_timed = windows * interval
    short = build_fused_chunk(
        system, dt=DT_PS, friction=1.0, n_replicas=R, bias_model=model,
        bias_quads=quads, bias_kind="metadynamics", mtd_sigma=MTD_SIGMA,
        mtd_deposit_interval=interval, mtd_height=mtd.height,
        mtd_bias_factor=mtd.bias_factor)
    sx, sv, sseeds, _ = _md_inputs(system, cx["x_min"], R, seed=11)
    xk, _, _, hk = short(sx, sv, sseeds, temps, n_timed, 0, hills=hills)
    xp, _, _, hp = short.reference(sx, sv, sseeds, temps, n_timed, 0, hills=hills)
    torch.cuda.synchronize()
    lo, hi = n_hills, n_hills + windows * R
    out["ledger_count"] = [int(hk.n_hills), int(hp.n_hills)]
    out["ledger_centers_max_abs_err"] = float((hk.centers - hp.centers).abs().max())
    out["ledger_heights_rel_err"] = float(
        ((hk.heights - hp.heights)[lo:hi].abs() / hp.heights[lo:hi].abs()).max())
    out["ledger_run_max_dx_nm"] = float((xk - xp).abs().max())
    _check(int(hk.n_hills) == int(hp.n_hills) == hi, f"ledger counts {out['ledger_count']}")
    _check(out["ledger_centers_max_abs_err"] <= 1e-4, "ledger centers agree")
    _check(out["ledger_heights_rel_err"] <= 1e-4, "ledger heights agree")
    _check(out["ledger_run_max_dx_nm"] <= 1e-3, "fused metadynamics positions agree")
    out["timed_steps"] = n_timed
    out["fused_mtd_ms"] = _cuda_ms(
        lambda: short(sx, sv, sseeds, temps, n_timed, 0, hills=hills), 5)
    out["fused_mtd_shape"] = _shape(short)
    out["fused_mtd_plain_ms"] = _cuda_ms(
        lambda: short.reference(sx, sv, sseeds, temps, n_timed, 0, hills=hills), 1)
    _line("phase 10 learned cv", out)
    # handed on, not printed: phase 23 analyses these frames
    out.update(remd=res, info=info, x_min=cx["x_min"])
    return out


def _walk_figures(counts: torch.Tensor, patches: int) -> dict:
    """The walk's figures from the pairs inside the cutoff of each patch
    that holds any (``counts``): patches walked, pairs queued, batches of 32
    (a patch's last batch may be short) and pairs a batch."""
    pairs = int(counts.sum())
    batches = int(((counts + 31) // 32).sum())
    return {"patches": patches, "pairs_queued": pairs, "batches": batches,
            "pairs_a_batch": pairs / max(batches, 1)}


def _dense_walk(fn, x: torch.Tensor) -> dict:
    """``periodic_force_kernel``'s walk on ``x (R, N, 3)``: every patch (row
    group g, column group h >= g of 32-atom groups), the unordered pairs it
    queues (band-masked, inside the cutoff on the kernel's float32 minimum
    image and r^2), in batches of 32 a patch."""
    from pmarlo_tpu_torch.md.periodic_force import cutoff_mask

    R, n = x.shape[0], x.shape[1]
    NG = -(-n // 32)
    box = fn._box32
    inv_box = 1.0 / box
    jj = torch.arange(n, device=x.device)
    counts = torch.zeros((R, NG, NG), dtype=torch.int64, device=x.device)
    for r in range(R):
        for s0 in range(0, n, 256):
            s1 = min(s0 + 256, n)
            d = x[r, s0:s1, None, :] - x[r, None, :, :]
            d = d - box * torch.round(d * inv_box)
            ii = torch.arange(s0, s1, device=x.device)[:, None]
            keep = (jj[None, :] > ii) & ((ii - jj[None, :]).abs() > fn.band_D) & cutoff_mask(
                d, fn.phys.rc)
            keep = torch.nn.functional.pad(keep.int(), (0, NG * 32 - n, 0, (-(s1 - s0)) % 32))
            counts[r, s0 // 32:s0 // 32 + keep.shape[0] // 32] = keep.reshape(
                keep.shape[0] // 32, 32, NG, 32).sum((1, 3))
    return _walk_figures(counts, R * NG * (NG + 1) // 2)


def _cell_walk(fn, xw: torch.Tensor, order: torch.Tensor, cell_start: torch.Tensor) -> dict:
    """``cell_force_kernel``'s walk on a binning: the 32 x 32 patches of its
    items (the own cell g <= h, each forward neighbour every pair of
    groups), and the pairs the plain version's ``half_shell`` yields (the
    kernel's pairs), in batches of 32 a patch."""
    from pmarlo_tpu_torch.md.cell_force import HALF_SHELL

    R = xw.shape[0]
    counts, patches = [], 0
    for r in range(R):
        cs = cell_start[r].long()
        groups = (cs[1:] - cs[:-1] + 31) // 32                       # (C,)
        patches += int((groups * (groups + 1) // 2).sum())
        for k in HALF_SHELL[1:]:
            patches += int((groups * groups[fn._nb[k]]).sum())
        MG = max(int(groups.max()), 1)
        keys = []
        for ai, aj, _, pi, pj, cells, k in fn.half_shell(xw[r], order[r], cell_start[r]):
            gi = (pi - cs[cells]) // 32
            gj = (pj - cs[fn._nb[k][cells]]) // 32
            keys.append(((cells * 14 + (k - 13)) * MG + gi) * MG + gj)
        if keys:
            counts.append(torch.bincount(torch.cat(keys)))
    counts = torch.cat(counts) if counts else torch.zeros(1, dtype=torch.int64)
    return _walk_figures(counts, patches)


def _periodic_bound(pairs: float, R: int, N: int, *, switch: bool = False,
                    ewald: bool = False, extra_bytes: int = 0) -> dict:
    """Bound of one periodic sweep: ``pairs`` unordered pairs inside the
    cutoff, each once; positions and the three per-atom rows in, float64
    energy rows and float32 forces out."""
    flops, sfu = PERIODIC_PAIR_OPS
    for on, (f, t) in ((switch, PERIODIC_SWITCH_OPS), (ewald, PERIODIC_EWALD_OPS)):
        if on:
            flops, sfu = flops + f, sfu + t
    n_bytes = R * N * (12 + 8 + 12) + 12 * N + extra_bytes
    return _bound(pairs * flops, pairs * sfu, n_bytes)


def _noisy(x_min: torch.Tensor, R: int, seed: int, sigma: float = 0.005) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return x_min[None] + torch.as_tensor(
        rng.normal(0.0, sigma, (R,) + tuple(x_min.shape)), dtype=torch.float32,
        device="cuda")


def _oracle(system, x: torch.Tensor):
    """Autograd of the dense float64 periodic energy, one replica at a time."""
    from pmarlo_tpu_torch.md.forces import energy_and_forces_autograd

    out = [energy_and_forces_autograd(system, xr.double()) for xr in x]
    return torch.stack([e for e, _ in out]), torch.stack([f for _, f in out])


def _gate(out: dict, tag: str, e, f, e_ref, f_ref) -> None:
    """Energy to 1e-5 relative, forces to 1e-4 of max |F|."""
    out[f"{tag}_energy_rel_err"] = _rel(e.double(), e_ref.double())
    out[f"{tag}_force_rel_err"] = _rel(f.double(), f_ref.double())
    _check(out[f"{tag}_energy_rel_err"] <= 1e-5, f"{tag} energy {out[f'{tag}_energy_rel_err']}")
    _check(out[f"{tag}_force_rel_err"] <= 1e-4, f"{tag} forces {out[f'{tag}_force_rel_err']}")


def _on_cutoff_atoms(x: torch.Tensor, box, rc: float, tol: float = 4e-6,
                     chunk: int = 1024) -> torch.Tensor:
    """``(R, N)`` bool: atoms of ``x (R, N, 3)`` that have a pair with
    ``|r^2 - rc^2| <= tol rc^2`` in the orthorhombic ``box`` (float64
    arithmetic). The dense sweep takes the minimum image of a raw
    difference and the cell sweep adds a lattice shift to wrapped
    coordinates: their float32 r^2 differ by a few units in the last place
    of a box length times 2 r (about 1e-6 rc^2 here), so one may cut such a
    pair and the other keep it, and the shifted potential's force jumps
    there. ``tol`` is four times that."""
    R, n = x.shape[0], x.shape[1]
    xd = x.double()
    b = torch.as_tensor(box, dtype=torch.float64, device=x.device)
    flagged = torch.zeros((R, n), dtype=torch.bool, device=x.device)
    for r in range(R):
        for s in range(0, n, chunk):
            d = xd[r, s:s + chunk, None, :] - xd[r, None, :, :]
            d = d - b * torch.round(d / b)
            near = ((d * d).sum(-1) - rc * rc).abs() <= tol * rc * rc
            flagged[r, s:s + chunk] = near.any(-1)
    return flagged


class _SkinRule:
    """The JAX package's rebin rule around a ``CellForce``, kept here to be
    measured against the port's (a sort on every call): the cell assignment
    stays while no atom has moved more than half the grid's slack from
    where it was binned, the swept coordinates advancing by the raw
    displacement; the test is read back to the host on every call."""

    def __init__(self, fn):
        from pmarlo_tpu_torch.md.cells import free_skin

        self.fn = fn
        self.half_skin2 = (0.5 * free_skin(fn.grid)) ** 2
        self.sorts = 0

    def __call__(self, x):
        return self.fn(x)

    def init_state(self, x):
        self.sorts += 1
        return self.fn.init_state(x), x

    def kept(self, x, carry):
        """The carry's assignment with its coordinates advanced to ``x``."""
        st, x_ref = carry
        return dataclasses.replace(st, xw=st.xw + (x - x_ref)[None])

    def apply(self, x, carry):
        disp = x - carry[1]
        if bool((disp * disp).sum(-1).max() > self.half_skin2):
            carry = self.init_state(x)
        energy, forces = self.fn.evaluate(x[None], self.kept(x, carry))
        return energy[0], forces[0], carry


def _solvated_chignolin(switch=None):
    from pmarlo_tpu_torch.io.pdb import read_pdb
    from pmarlo_tpu_torch.md.forcefield import build_system

    st = read_pdb(SOLVATED_PDB)
    return build_system(st, box=st.box, cutoff=EXPLICIT_CUTOFF, switch_distance=switch,
                        device="cuda")


def phase_periodic() -> dict:
    """``periodic_force.cu`` against its plain version and the dense
    autograd oracle on solvated chignolin, R=8."""
    from pmarlo_tpu_torch.md.minimize import minimize_energy
    from pmarlo_tpu_torch.md.periodic_force import build_periodic_force_fn

    R = EXPLICIT_REPLICAS
    out = {"replicas": R}
    keep = {}
    for tag, switch in (("shifted", None), ("switched", EXPLICIT_SWITCH)):
        system, positions = _solvated_chignolin(switch)
        fn = build_periodic_force_fn(system)
        if tag == "shifted":
            x_min, _ = minimize_energy(system, positions, force_fn=fn)
            x = _noisy(x_min, R, seed=11)
            # float32 and float64 r^2 may cut a pair on the cutoff
            # differently: such atoms are left out against the oracle
            clear = ~_on_cutoff_atoms(x, system.box, EXPLICIT_CUTOFF)
            out.update(atoms=system.n_atoms, band=fn.band_D,
                       atoms_with_a_pair_on_the_cutoff=int((~clear).sum()))
            clear = clear[..., None]
        ek, fk = fn.sweep(x)
        ep, fp = fn.sweep_reference(x)
        _gate(out, f"{tag}_sweep", ek.sum(-1), fk, ep.sum(-1), fp)
        out[f"{tag}_e_rows_rel_err"] = _rel(ek, ep)
        out[f"{tag}_force_max_abs_err"] = float((fk - fp).abs().max())
        e, f = fn(x)
        er, fr = fn.reference(x)
        _gate(out, f"{tag}_eval", e, f, er, fr)
        eo, fo = _oracle(system, x)
        _gate(out, f"{tag}_vs_oracle", e, f * clear, eo, fo * clear)
        out[f"{tag}_vs_oracle_force_rel_err_all_atoms"] = _rel(f.double(), fo)
        _check(bool(torch.isfinite(f).all()), f"{tag}: periodic forces finite")
        keep[tag] = (system, e, f)
        if tag == "shifted":
            shifted_fn = fn
    system, fn = keep["shifted"][0], shifted_fn
    N = system.n_atoms
    ek, fk = fn.sweep(x)
    ek2, fk2 = fn.sweep(x)
    out["periodic_two_launches_bitwise_equal"] = bool(torch.equal(ek, ek2)
                                                      and torch.equal(fk, fk2))
    _check(out["periodic_two_launches_bitwise_equal"], "periodic kernel run to run")
    # the walk's patches and batches; its pairs are the bound's
    walk = _dense_walk(fn, x)
    out.update({f"walk_{k}": v for k, v in walk.items()})
    out["sweep_ms"] = _cuda_ms(lambda: fn.sweep(x), 20)
    out["sweep_plain_ms"] = _cuda_ms(lambda: fn.sweep_reference(x), 3)
    out["eval_ms"] = _cuda_ms(lambda: fn(x), 20)
    out["eval_plain_ms"] = _cuda_ms(lambda: fn.reference(x), 3)
    out.update(_periodic_bound(walk["pairs_queued"], R, N))
    out["bound_share"] = out["bound_ms"] / out["sweep_ms"]
    _line("phase 11 periodic kernel", out)
    out.update(x_min=x_min, x=x, keep=keep, clear=clear)
    return out


def _water_box_system():
    """The 27,783-atom TIP3P box: system, lattice positions, constraints
    and the MD system (constrained bonded terms stripped)."""
    from pmarlo_tpu_torch.data.water import water_box_structure
    from pmarlo_tpu_torch.md.constraints import build_h_constraints, strip_constrained_bonded
    from pmarlo_tpu_torch.md.forcefield import build_system

    structure, box = water_box_structure(WATER_SIDE)
    system, x0 = build_system(structure, box=box, cutoff=EXPLICIT_CUTOFF,
                              hydrogen_mass=None, device="cuda")
    spec = build_h_constraints(system)
    return system, x0, spec, strip_constrained_bonded(system)


def phase_cells(periodic: dict, water) -> dict:
    """``cell_force.cu`` against its plain version, the dense oracle and the
    periodic kernel; a sheared box; the water box; the skin."""
    from pmarlo_tpu_torch.data.water import water_box_structure
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn
    from pmarlo_tpu_torch.md.cells import bin_atoms, free_skin
    from pmarlo_tpu_torch.md.forcefield import build_system
    from pmarlo_tpu_torch.md.integrate import langevin_step, thermalize

    R = EXPLICIT_REPLICAS
    x = periodic["x"]
    out = {"replicas": R}
    e_rf = None
    # the two routes may cut a pair on the cutoff differently: such atoms
    # (counted in phase 11) are left out where one route is held against
    # the other or against the oracle
    clear = periodic["clear"]
    _check(int((~clear).sum()) <= 0.01 * clear.numel(), "few atoms lie on the cutoff")

    def sweeps(fn, xs):
        order, cell_start, _, xw = bin_atoms(fn.grid, xs)
        order, cell_start = order.contiguous(), cell_start.contiguous()
        return (fn.sweep(xw, order, cell_start), fn.sweep_reference(xw, order, cell_start),
                (xw, order, cell_start))

    # (a) solvated chignolin: three modes, three references
    for tag, switch, alpha in (("rf", None, None), ("switched", EXPLICIT_SWITCH, None),
                               ("ewald", None, EWALD_ALPHA)):
        system, e_dense, f_dense = periodic["keep"]["switched" if switch else "shifted"]
        fn = build_cell_force_fn(system, electrostatics="pme" if alpha else "rf")
        (ek, fk), (ep, fp), _ = sweeps(fn, x)
        _gate(out, f"{tag}_sweep", ek.sum(-1), fk, ep.sum(-1), fp)
        out[f"{tag}_force_max_abs_err"] = float((fk - fp).abs().max())
        e, f = fn(x)
        er, fr = fn.reference(x)
        _gate(out, f"{tag}_eval", e, f, er, fr)
        _check(bool(torch.isfinite(f).all()), f"{tag}: cell forces finite")
        if alpha is None:
            # the reaction-field modes have a dense oracle and a dense kernel
            eo, fo = _oracle(system, x)
            _gate(out, f"{tag}_vs_oracle", e, f * clear, eo, fo * clear)
            _gate(out, f"{tag}_vs_periodic_kernel", e, f * clear, e_dense, f_dense * clear)
            out[f"{tag}_vs_periodic_kernel_force_rel_err_all_atoms"] = _rel(f, f_dense)
        else:
            _check(fn.electrostatics == "pme" and fn.phys.shift_c > 0.0
                   and abs(fn.phys.alpha - alpha) <= 1e-12 * alpha, "smooth PME is on")
            out["ewald_alpha"] = alpha
            out["ewald_minus_rf_energy"] = float((e - e_rf).abs().max())
            _check(out["ewald_minus_rf_energy"] > 1.0, "the Ewald term differs from RF")
        if tag == "rf":
            # the shape of phase 13's launches: R=8, 3 x 3 x 2 cells
            e_rf = e
            g = fn.grid
            out["chignolin_grid"] = [g.nx, g.ny, g.nz]
            binned = sweeps(fn, x)[2]
            _bitwise(out, "chignolin", fn, binned)
            walk = _cell_walk(fn, *binned)
            out.update({f"chignolin_walk_{k}": v for k, v in walk.items()})
            out["chignolin_sweep_ms"] = _cuda_ms(lambda: fn.sweep(*binned), 20)
            out["chignolin_sweep_plain_ms"] = _cuda_ms(lambda: fn.sweep_reference(*binned), 3)
            out["chignolin_eval_ms"] = _cuda_ms(lambda: fn(x), 20)
            bound = _periodic_bound(walk["pairs_queued"], R, system.n_atoms,
                                    extra_bytes=4 * R * (system.n_atoms + g.n_cells + 1))
            out["chignolin_bound_ms"] = bound["bound_ms"]
            out["chignolin_bound_by"] = bound["bound_by"]
            out["chignolin_bound_share"] = bound["bound_ms"] / out["chignolin_sweep_ms"]

    # (b) a sheared 375-atom water box (the JAX package's triclinic test cell)
    s5, box5 = water_box_structure(5)
    tri, x5 = build_system(s5, box=box5, tilt=(0.2, 0.2, 0.2), cutoff=0.45,
                           hydrogen_mass=None, device="cuda")
    fn = build_cell_force_fn(tri)
    xs = _noisy(x5, 4, seed=12, sigma=0.02)
    e, f = fn(xs)
    er, fr = fn.reference(xs)
    _gate(out, "sheared_eval", e, f, er, fr)
    eo, fo = _oracle(tri, xs)
    _gate(out, "sheared_vs_oracle", e, f, eo, fo)

    # (c) the 27,783-atom water box
    wsys, x0, _, _ = water
    N = wsys.n_atoms
    fn = build_cell_force_fn(wsys)
    g = fn.grid
    out.update(water_atoms=N, water_grid=[g.nx, g.ny, g.nz], water_skin_nm=free_skin(g),
               water_band=fn.band_D)
    for Rw in (1, 4):
        xw_in = _noisy(x0, Rw, seed=13, sigma=0.02)
        (ek, fk), (ep, fp), binned = sweeps(fn, xw_in)
        tag = f"water_r{Rw}"
        _gate(out, f"{tag}_sweep", ek.sum(-1), fk, ep.sum(-1), fp)
        out[f"{tag}_force_max_abs_err"] = float((fk - fp).abs().max())
        e, f = fn(xw_in)
        er, fr = fn.reference(xw_in)
        _gate(out, f"{tag}_eval", e, f, er, fr)
        counts = (binned[2][:, 1:] - binned[2][:, :-1]).double()
        out[f"{tag}_max_cell_occupancy"] = int(counts.max())
        _bitwise(out, tag, fn, binned)
        walk = _cell_walk(fn, *binned)
        out.update({f"{tag}_walk_{k}": v for k, v in walk.items()})
        out[f"{tag}_sweep_ms"] = _cuda_ms(lambda: fn.sweep(*binned), 20)
        out[f"{tag}_sweep_plain_ms"] = _cuda_ms(lambda: fn.sweep_reference(*binned), 2)
        out[f"{tag}_bin_ms"] = _cuda_ms(lambda: bin_atoms(fn.grid, xw_in), 20)
        out[f"{tag}_eval_ms"] = _cuda_ms(lambda: fn(xw_in), 20)
        bound = _periodic_bound(walk["pairs_queued"], Rw, N,
                                extra_bytes=4 * Rw * (N + g.n_cells + 1))
        out[f"{tag}_bound_ms"] = bound["bound_ms"]
        out[f"{tag}_bound_by"] = bound["bound_by"]
        out[f"{tag}_bound_share"] = bound["bound_ms"] / out[f"{tag}_sweep_ms"]

    # (d) the cover of a kept assignment: 200 steps under the displacement
    # rule, then the kept assignment against a fresh binning
    _, _, spec, md_system = water
    rule = _SkinRule(build_cell_force_fn(md_system))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    state = thermalize(wsys, x0, gen, 300.0)
    carry = rule.init_state(state.positions)
    for _ in range(SKIN_STEPS):
        state, _, carry = langevin_step(
            wsys, state, dt=DT_PS, friction=1.0, temperature_K=300.0, force_fn=rule.apply,
            constraints=spec, force_state=carry)
    e_kept, f_kept = rule.fn.evaluate(state.positions[None],
                                      rule.kept(state.positions, carry))
    e_new, f_new = rule.fn(state.positions[None])
    out["skin_steps"] = SKIN_STEPS
    out["skin_sorts"] = rule.sorts - 1
    _gate(out, "skin_kept_vs_fresh", e_kept, f_kept, e_new, f_new)
    _check(0 < out["skin_sorts"] < SKIN_STEPS,
           f"{out['skin_sorts']} sorts in {SKIN_STEPS} steps")
    _line("phase 12 cell kernel", out)
    return out


def _bitwise(out: dict, tag: str, fn, binned) -> None:
    """Two launches of the cell kernel on one binning give the same bits."""
    ek, fk = fn.sweep(*binned)
    ek2, fk2 = fn.sweep(*binned)
    key = f"{tag}_cell_two_launches_bitwise_equal"
    out[key] = bool(torch.equal(ek, ek2) and torch.equal(fk, fk2))
    _check(out[key], f"{tag}: cell kernel run to run")


def phase_explicit_remd() -> dict:
    """The explicit-solvent path through ``run_replica_exchange``, once by
    each engine."""
    from pmarlo_tpu_torch.md.constraints import build_h_constraints, constraint_violation
    from pmarlo_tpu_torch.remd.remd import RemdConfig, run_replica_exchange

    R = EXPLICIT_REPLICAS
    cfg = RemdConfig(
        n_replicas=R, t_min=300.0, t_max=330.0, exchange_frequency=100,
        report_interval=EXPLICIT_REPORT, dt_ps=DT_PS, seed=0,
        friction_per_ps=SHORT_RUN_FRICTION,
    )
    # one launch per force evaluation: 500 FIRE iterations + the final
    # energy, one per MD step, one per frame
    evals = 501 + EXPLICIT_STEPS + EXPLICIT_STEPS // cfg.report_interval
    out = {"replicas": R, "steps": EXPLICIT_STEPS, "dt_ps": cfg.dt_ps,
           "force_evaluations": evals}
    for nonbonded, kernel, other in (("auto", "periodic_force", "cell_force"),
                                     ("cells", "cell_force", "periodic_force")):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res, system = run_replica_exchange(
            SOLVATED_PDB, n_steps=EXPLICIT_STEPS, config=cfg, device="cuda",
            nonbonded=nonbonded)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = _counts()
        spec = build_h_constraints(system)
        deviation = float(constraint_violation(
            spec, torch.as_tensor(res.positions, device="cuda")))
        # kinetic/target over the second half of the run (the start is a
        # minimized structure: its kinetic energy halves at once)
        half = res.kinetic_temperature.shape[0] // 2
        ratio = res.kinetic_temperature[half:] / res.temperatures[None, :]
        sim_ns = EXPLICIT_STEPS * cfg.dt_ps * 1e-3 * R
        tag = "dense" if nonbonded == "auto" else "cells"
        out[tag] = {
            "atoms": system.n_atoms,
            "constraints": spec.n_constraints,
            "launches": {kernel: counts[kernel], other: counts[other]},
            "total_wall_s": total,
            "run_wall_s": res.wall_seconds,
            "ms_per_step": res.wall_seconds / EXPLICIT_STEPS * 1e3,
            "ns_per_day_aggregate": sim_ns * 86_400.0 / res.wall_seconds,
            "mean_acceptance": res.mean_acceptance,
            "pair_acceptance": [float(a) for a in res.acceptance_matrix],
            "kinetic_over_target": float(ratio.mean()),
            "kinetic_over_target_by_frame": [float(r) for r in (
                res.kinetic_temperature / res.temperatures[None, :]).mean(1)],
            "max_constraint_deviation_nm": deviation,
            "frames": list(res.positions.shape),
        }
        _check(system.device.type == "cuda" and system.box is not None,
               f"{tag}: a periodic system on the card")
        # "auto" at 2,315 atoms is the dense sweep: every evaluation
        # launched this engine's kernel and none the other's
        _check(counts[kernel] == evals and counts[other] == 0,
               f"{tag}: launches {counts} for {evals} force evaluations")
        _check(all(counts[k] == 0 for k in PAIR_KERNELS) and counts["fused_md_chunk"] == 0,
               f"{tag}: an implicit-solvent kernel ran")
        _check(bool(np.isfinite(res.positions).all()), f"{tag}: frames finite")
        _check(bool(np.isfinite(res.potential_energy).all()), f"{tag}: energies finite")
        _check(deviation <= 1e-4, f"{tag}: constraint deviation {deviation} nm")
        _check(0.0 < res.mean_acceptance < 1.0, f"{tag}: acceptance {res.mean_acceptance}")
        _check(0.95 <= out[tag]["kinetic_over_target"] <= 1.05,
               f"{tag}: kinetic/target {out[tag]['kinetic_over_target']}")
    _line("phase 13 explicit remd", out)
    return out


def phase_water_md(water) -> dict:
    """``thermalize`` + ``run_md`` on the 27,783-atom water box through the
    cell kernel's stateful entries."""
    from pmarlo_tpu_torch.constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn
    from pmarlo_tpu_torch.md.constraints import constraint_violation
    from pmarlo_tpu_torch.md.integrate import run_md, thermalize
    from pmarlo_tpu_torch.md.minimize import minimize_energy

    system, x0, spec, md_system = water
    N = system.n_atoms
    out = {"atoms": N, "constraints": spec.n_constraints, "dt_ps": DT_PS}
    # the lattice start relaxes through the FULL system's sweep first
    x_min, _ = minimize_energy(system, x0, force_fn=build_cell_force_fn(system),
                               max_iterations=100)
    fn = build_cell_force_fn(md_system)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    kw = dict(dt=DT_PS, temperature_K=300.0, force_fn=fn, constraints=spec)
    torch.cuda.synchronize()
    _reset_counts()
    state = thermalize(system, x_min, gen, 300.0)
    state, _ = run_md(system, state, n_steps=WATER_WARM_STEPS, friction=1.0,
                      report_interval=WATER_WARM_STEPS, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, frames = run_md(system, state, n_steps=WATER_STEPS, friction=1.0,
                           report_interval=100, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out.update({
        "steps": WATER_STEPS,
        "ms_per_step": wall / WATER_STEPS * 1e3,
        "ns_per_day": WATER_STEPS * DT_PS * 1e-3 * 86_400.0 / wall,
        "kinetic_over_target": float(frames["temperature"].mean() / 300.0),
        "kinetic_over_target_last": float(frames["temperature"][-1] / 300.0),
        "max_constraint_deviation_nm": float(constraint_violation(spec, frames["positions"])),
    })
    _check(state.positions.is_cuda, "water-box state on the card")
    _check(bool(torch.isfinite(frames["positions"]).all()), "water-box frames finite")
    _check(bool(torch.isfinite(frames["potential_energy"]).all()), "water-box energies finite")
    _check(out["max_constraint_deviation_nm"] <= 1e-4,
           f"water-box constraint deviation {out['max_constraint_deviation_nm']}")
    _check(0.8 <= out["kinetic_over_target"] <= 1.25,
           f"water-box kinetic/target {out['kinetic_over_target']}")

    # NVE: friction 0; total energy at 10 reports, the slope of a linear fit
    nve, nf = run_md(system, state, n_steps=WATER_NVE_STEPS, friction=0.0,
                     report_interval=50, **kw)
    torch.cuda.synchronize()
    counts = _counts()
    dof = 3 * N - spec.n_constraints - 3
    kT = BOLTZMANN_CONSTANT_KJ_PER_MOL * 300.0
    e_tot = (nf["potential_energy"].double()
             + 0.5 * dof * BOLTZMANN_CONSTANT_KJ_PER_MOL * nf["temperature"].double()
             ).cpu().numpy()
    t_ps = (np.arange(len(e_tot)) + 1) * 50 * DT_PS
    slope = float(np.polyfit(t_ps, e_tot, 1)[0])          # kJ/mol/ps
    out.update({
        "nve_steps": WATER_NVE_STEPS,
        "nve_drift_kT_per_dof_per_ns": slope * 1e3 / (kT * dof),
        "nve_energy_span_kj_mol": float(e_tot.max() - e_tot.min()),
        "launches": counts["cell_force"],
    })
    _check(bool(np.isfinite(e_tot).all()), "NVE energies finite")
    # each force is the exact gradient of its kernel's energy: the drift
    # stays under NVE_DRIFT_MAX
    _check(abs(out["nve_drift_kT_per_dof_per_ns"]) < NVE_DRIFT_MAX,
           f"NVE drift {out['nve_drift_kT_per_dof_per_ns']} kT per degree of freedom per ns")
    # one launch per step and per report; the minimization ran before the reset
    expected = (WATER_WARM_STEPS + 1 + WATER_STEPS + WATER_STEPS // 100
                + WATER_NVE_STEPS + WATER_NVE_STEPS // 50)
    _check(counts["cell_force"] == expected and counts["periodic_force"] == 0,
           f"water-box launches {counts}, expected {expected}")

    # the main path sorts on every call and reads nothing back. Against it
    # the displacement rule (a sort only when an atom outran half the slack,
    # one host read a call): stretches of each from one start, alternating,
    # so that a drift of the host's speed falls on both
    rule = _SkinRule(fn)
    start, _ = run_md(system, nve, n_steps=20, friction=1.0, report_interval=20, **kw)
    readings = {"skin": [], "always": []}
    for _ in range(WATER_REBIN_ROUNDS):
        for tag, f in (("skin", rule), ("always", fn)):
            kw["force_fn"] = f
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_md(system, start, n_steps=WATER_REBIN_STEPS, friction=1.0,
                   report_interval=100, **kw)
            torch.cuda.synchronize()
            readings[tag].append((time.perf_counter() - t0) / WATER_REBIN_STEPS * 1e3)
    calls = WATER_REBIN_ROUNDS * (WATER_REBIN_STEPS + WATER_REBIN_STEPS // 100 + 1)
    out["rebin_steps_a_stretch"] = WATER_REBIN_STEPS
    out["rebin_skin_sorts_per_call"] = rule.sorts / calls
    for tag, ms in readings.items():
        out[f"rebin_{tag}_ms_per_step"] = ms
        out[f"rebin_{tag}_median_ms_per_step"] = float(np.median(ms))
    _check(rule.sorts < calls, f"the displacement rule made {rule.sorts} sorts in {calls} calls")
    _line("phase 14 water md", out)
    return out


def _large_system(copies):
    """A chignolin assembly in GBn2 on the card, without (N, N) tables."""
    from pmarlo_tpu_torch.data.chignolin import chignolin_assembly
    from pmarlo_tpu_torch.md.forcefield import build_system

    return build_system(chignolin_assembly(copies), gb_model="gbn2", device="cuda",
                        dense_scales=False)


def _pair_counts(fn, xs: torch.Tensor, close=None):
    """``(pairs, near)`` at the stored positions ``xs (R, N, 3)``: the
    ordered pairs that the ordered plain version's own pair mask counts
    (inside the GB cutoff where there is one), and those of them whose HCT
    value takes the near form (csrc/gb_force.cuh hct_value: not |sr_j / r|
    <= 0.3 with r - sr_j >= rho_i), each BORN_NEAR_SFU results more."""
    pairs = near = 0
    for s, e, cols, _, r, one in fn._blocks(xs, close):
        sr_j = fn._at(fn.sr, cols)[None, :]
        far = ((sr_j / r).abs() <= 0.3) & (r - sr_j >= fn.rho[s:e, None])
        pairs += int(one.sum())
        near += int((one * ~far).sum())
    return pairs, near


def _culled_bound(tag: str, within: float, near: float, R: int, N: int) -> dict:
    """Bound of one culled or Newton sweep: the ``within`` ordered pairs
    inside the cutoff, each unordered pair once at NEWTON_OPS, and for the
    Born sweep the ``near`` directions' special functions; positions, five
    per-atom rows, class and index rows, Born radii and chain coefficients
    in, one to three rows out."""
    flops, sfu = NEWTON_OPS[tag]
    extra = near * BORN_NEAR_SFU if tag == "born" else 0.0
    n_bytes = R * N * (12 + 8 + 12) + 28 * N
    return _bound(0.5 * within * flops, 0.5 * within * sfu + extra, n_bytes)


def _visited_within(fo, xs: torch.Tensor, close: torch.Tensor):
    """Ordered pairs in the tile blocks that ``close`` keeps, those of them
    inside the cutoff, and those of these whose HCT value takes the near
    form, at the stored positions ``xs (1, N, 3)``."""
    N = xs.shape[1]
    sizes = torch.full((fo.n_tiles,), float(fo.tile), device="cuda")
    sizes[-1] = N - (fo.n_tiles - 1) * fo.tile
    visited = float((close[0].double() * sizes[:, None] * sizes[None, :]).sum())
    return (visited, *_pair_counts(fo, xs, close))


def _patch_shares(fn, xs: torch.Tensor, close: torch.Tensor, within: float,
                  chunk: int = 512) -> dict:
    """What the three Newton kernels meet at the stored positions ``xs (R,
    N, 3)``: they all walk one list (``PairForce.patch_list``), the 32 x 32
    patches of the blocks (r, c >= r) that ``close`` keeps (a diagonal
    block's on or above its diagonal) that the group-box test lists; the
    blocks and their patches, the share of the patches listed (the work
    items), the share of the items that holds a pair inside the cutoff, and
    the unordered pairs inside the cutoff an item (``within``: the ordered
    pairs inside it)."""
    from pmarlo_tpu_torch.md.pair_force import cutoff_pairs, tile_boxes, tiles_within

    R, N = xs.shape[:2]
    ng = -(-N // 32)
    hit = torch.zeros((R, ng, ng), dtype=torch.bool, device=xs.device)
    for s in range(0, N, chunk):
        e = min(s + chunk, N)
        d = xs[:, s:e, None, :] - xs[:, None, :, :]
        inside = cutoff_pairs(d, fn.gb_cutoff) & ((d * d).sum(-1) > 1e-8)
        rows = -(-(e - s) // 32) * 32
        inside = torch.nn.functional.pad(inside, (0, ng * 32 - N, 0, rows - (e - s)))
        hit[:, s // 32:s // 32 + rows // 32] = inside.reshape(
            R, rows // 32, 32, ng, 32).any(4).any(2)
    group_tile = torch.arange(ng, device=xs.device) // (fn.tile // 32)
    g = torch.arange(ng, device=xs.device)
    computed = close[:, group_tile][:, :, group_tile] & (g[None, :] >= g[:, None])
    listed = computed & tiles_within(*tile_boxes(xs, 32), fn.gb_cutoff)
    n_computed, n_listed = int(computed.sum()), int(listed.sum())
    return {
        "blocks": int(torch.triu(close).sum()),
        "patches_of_blocks": n_computed,
        "items": n_listed,
        "item_share_of_patches": n_listed / n_computed,
        "item_share_with_pair_within": int((listed & hit).sum()) / n_listed,
        "pairs_within_per_item": 0.5 * within / n_listed,
    }


def _sweeps_vs_plain(out: dict, prefix: str, fn, x: torch.Tensor, max_abs: bool):
    """Each of ``fn``'s three sweeps, and the whole evaluation, against its
    plain version at the positions ``x (R, N, 3)``: I, e_rows, dE/dB and the
    total energy to 1e-5 relative, forces to 1e-4 of max |F|. Returns the
    Born radii and chain coefficients (for the timed sweeps)."""
    xs = fn.to_storage(x)
    Ip, Ik = fn.born_reference(xs), fn.born(xs)
    B, dB = fn.born_radii(Ip)
    (ep, dp), (ek, dk) = fn.energy_rows_reference(xs, B), fn.energy_rows(xs, B)
    _, c = fn.gb_terms(B, dB, dp)
    Fp, Fk = fn.pair_forces_reference(xs, B, c), fn.pair_forces(xs, B, c)
    Ek, Gk = fn(x)
    Ep, Gp = fn.reference(x)
    torch.cuda.synchronize()
    errs = {
        "born_rel_err": _rel(Ik, Ip), "e_rows_rel_err": _rel(ek, ep),
        "dEdB_rel_err": _rel(dk, dp), "force_rel_err": _rel(Fk, Fp),
        "total_energy_rel_err": _rel(Ek, Ep), "total_force_rel_err": _rel(Gk, Gp),
    }
    for key, err in errs.items():
        out[f"{prefix}_{key}"] = err
        _check(err <= (1e-4 if "force" in key else 1e-5), f"{prefix} {key} {err}")
    _check(bool(torch.isfinite(Gk).all()), f"{prefix} forces finite")
    if max_abs:
        out[f"{prefix}_born_max_abs_err"] = float((Ik - Ip).abs().max())
        out[f"{prefix}_dEdB_max_abs_err"] = float((dk - dp).abs().max())
        out[f"{prefix}_force_max_abs_err"] = float((Fk - Fp).abs().max())
    return B, c


def _time_sweeps(out: dict, mode: str, fn, xs, B, c, close, within, near) -> None:
    """ms of each sweep of ``fn`` and of its plain version at the stored
    positions ``xs (1, N, 3)``, beside the bound from this run's pairs."""
    for tag, kernel, plain in (
        ("born", lambda: fn.born(xs, close), lambda: fn.born_reference(xs, close)),
        ("energy", lambda: fn.energy_rows(xs, B, close),
         lambda: fn.energy_rows_reference(xs, B, close)),
        ("force", lambda: fn.pair_forces(xs, B, c, close),
         lambda: fn.pair_forces_reference(xs, B, c, close)),
    ):
        out[f"{mode}_{tag}_ms"] = _cuda_ms(kernel, 20)
        out[f"{mode}_{tag}_plain_ms"] = _cuda_ms(plain, 1)
        bound = _culled_bound(tag, within, near, 1, xs.shape[1])
        out[f"{mode}_{tag}_bound_ms"] = bound["bound_ms"]
        out[f"{mode}_{tag}_bound_by"] = bound["bound_by"]


def _bonded_bound(system, R: int = 1) -> dict:
    """Bound of one bonded call of R replicas, the least work of the
    function (BONDED_OPS): each term once, positions and the terms' index
    and parameter rows in, the gradient and the energy out."""
    N = system.n_atoms
    counts = {k: int(getattr(system, f"{k}_idx").shape[0]) for k in ("bond", "angle", "torsion")}
    flops = sum(counts[k] * BONDED_OPS[k][0] for k in counts)
    sfu = sum(counts[k] * BONDED_OPS[k][1] for k in counts)
    n_bytes = (R * N * 12 * 2 + R * 8 + counts["bond"] * (8 + 8) + counts["angle"] * (12 + 8)
               + counts["torsion"] * (16 + 12))
    return _bound(R * flops, R * sfu, n_bytes)


def _ordered_walk(fn, xs: torch.Tensor, close: torch.Tensor, chunk: int = 512) -> dict:
    """The ordered culled kernels' walk (one for the three sweeps), replayed
    on the host at the stored positions ``xs (1, N, 3)``: the 32 x 32
    patches its items walk (row group g, column group h
    of the item's segment, tile kept by ``close``, group boxes within the
    cutoff), the ordered pairs it queues (inside the cutoff, coincident ones
    left out), and its batches of 32, replayed item by item as the kernel
    forms them (full batches, and the short ones where pairs of two patches
    back must go before their columns are overwritten and at an item's end)."""
    from pmarlo_tpu_torch.md.pair_force import (CULLED_SEGMENTS, _r2, cutoff_pairs, tile_boxes,
                                                tiles_within)

    N = xs.shape[1]
    ng = -(-N // 32)
    counts = torch.zeros((ng, ng), dtype=torch.int64, device=xs.device)
    for s in range(0, N, chunk):
        e = min(s + chunk, N)
        d = xs[0, s:e, None, :] - xs[0, None, :, :]
        inside = (cutoff_pairs(d, fn.gb_cutoff) & (_r2(d) > 1e-8)).int()
        rows = -(-(e - s) // 32) * 32
        inside = torch.nn.functional.pad(inside, (0, ng * 32 - N, 0, rows - (e - s)))
        counts[s // 32:s // 32 + rows // 32] = inside.reshape(rows // 32, 32, ng, 32).sum((1, 3))
    group_tile = torch.arange(ng, device=xs.device) // (fn.tile // 32)
    walked = (close[0][group_tile][:, group_tile]
              & tiles_within(*tile_boxes(xs, 32), fn.gb_cutoff)[0]).cpu().numpy()
    counts = counts.cpu().numpy()
    patches = pairs = batches = 0
    for g in range(ng):
        for seg in range(CULLED_SEGMENTS):
            queued = carried = 0
            for h in np.flatnonzero(walked[g, seg::CULLED_SEGMENTS]) * CULLED_SEGMENTS + seg:
                if carried:
                    batches += 1
                    queued = 0
                carried = queued
                full, queued = divmod(queued + int(counts[g, h]), 32)
                batches += full
                carried = 0 if full else carried
                patches += 1
                pairs += int(counts[g, h])
            batches += queued > 0
    return {"patches": patches, "pairs_queued": pairs, "batches": batches,
            "pairs_a_batch": pairs / max(batches, 1)}


def phase_large_kernels() -> dict:
    """The culled and Newton pair kernels against their plain versions,
    against each other and against the dense kernels, N=24,840."""
    from pmarlo_tpu_torch.md.minimize import minimize_energy
    from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn

    t0 = time.perf_counter()
    system, x0 = _large_system(LARGE_CHECK_COPIES)
    N = system.n_atoms
    out = {"atoms": N, "tile": LARGE_TILE, "gb_cutoff": GB_CUTOFF,
           "system_build_s": time.perf_counter() - t0}
    cut = dict(tile=LARGE_TILE, gb_cutoff=GB_CUTOFF)
    fns = {"culled": build_pair_force_fn(system, order_from=x0, newton=False, **cut),
           "newton": build_pair_force_fn(system, order_from=x0, newton=True, **cut)}
    x_min, _ = minimize_energy(system, x0, force_fn=fns["newton"], max_iterations=100)
    x1 = _noisy(x_min, 1, seed=21)
    x3 = _noisy(x_min, 3, seed=22)
    fo = fns["culled"]
    xs = fo.to_storage(x1)
    close = fo.close_tiles(xs)
    visited, within, near = _visited_within(fo, xs, close)
    out.update({
        "tile_blocks": fo.n_tiles ** 2,
        "tile_blocks_computed": int(close.sum()),
        "tile_block_share": float(close.float().mean()),
        "pairs_visited_share": visited / (N * N),
        "pairs_within_cutoff": within,
        "born_near_directions": near,
        "pairs_within_share_of_visited": within / visited,
        "newton_walk": _patch_shares(fo, xs, close, within),
    })

    for mode, fn in fns.items():
        B1, c1 = _sweeps_vs_plain(out, f"{mode}_r1", fn, x1, max_abs=True)
        _sweeps_vs_plain(out, f"{mode}_r3", fn, x3, max_abs=False)
    # the Newton Born kernel's share of newton_r1_total_energy_rel_err: the
    # evaluation with that kernel and the other sweeps plain
    fn = fns["newton"]
    E_bk, _ = fn._evaluate(x1, fn.born, fn.energy_rows_reference, fn.pair_forces_reference,
                           fn.bonded_reference)
    out["newton_r1_born_kernel_total_energy_rel_err"] = _rel(E_bk.double(),
                                                             fn.reference(x1)[0].double())

    # the Newton sweeps against the ordered ones, and against themselves:
    # their sums are atomic, so two runs differ in the last bits
    Eo, Go = fns["culled"](x3)
    En, Gn = fns["newton"](x3)
    En2, Gn2 = fns["newton"](x3)
    _gate(out, "newton_vs_ordered", En, Gn, Eo, Go)
    out["newton_run_to_run_force_rel"] = _rel(Gn2, Gn)
    out["newton_run_to_run_energy_rel"] = _rel(En2.double(), En.double())
    _check(out["newton_run_to_run_force_rel"] <= 1e-4, "Newton forces run to run")
    _check(out["newton_run_to_run_energy_rel"] <= 1e-5, "Newton energy run to run")
    # the ordered sweeps add in a fixed order: the same bits from a second launch
    xs3 = fo.to_storage(x3)
    B3, dB3 = fo.born_radii(fo.born(xs3))
    _, c3 = fo.gb_terms(B3, dB3, fo.energy_rows(xs3, B3)[1])
    again = all(torch.equal(a, b) for a, b in (
        (fo.born(xs3), fo.born(xs3)),
        (fo.energy_rows(xs3, B3)[0], fo.energy_rows(xs3, B3)[0]),
        (fo.pair_forces(xs3, B3, c3), fo.pair_forces(xs3, B3, c3))))
    _check(again, "ordered culled sweeps reproducible")

    # a cutoff beyond every pair is the dense physics: against the dense kernels
    dense = build_pair_force_fn(system)
    Ed, Gd = dense(x1)
    for mode, newton in (("culled", False), ("newton", True)):
        Eh, Gh = build_pair_force_fn(system, tile=LARGE_TILE, gb_cutoff=50.0,
                                     newton=newton)(x1)
        _gate(out, f"{mode}_huge_cutoff_vs_dense", Eh, Gh, Ed, Gd)
    # Morton order is a layout: identity order gives the same numbers, more blocks
    ident = build_pair_force_fn(system, newton=False, **cut)
    Ei, Gi = ident(x1)
    E1, G1 = fns["culled"](x1)
    _gate(out, "morton_vs_identity", E1, G1, Ei, Gi)
    out["identity_tile_block_share"] = float(ident.close_tiles(x1).float().mean())

    out["tile_table_ms"] = _cuda_ms(lambda: fo.close_tiles(xs), 20)
    out["newton_patch_list_ms"] = _cuda_ms(lambda: fns["newton"].patch_list(xs, close), 20)
    for mode, fn in fns.items():
        _time_sweeps(out, mode, fn, xs, B1, c1, close, within, near)
        out[f"{mode}_eval_ms"] = _cuda_ms(lambda: fn(x1), 10)
    # the dense kernels at the same N (their own Born radii: other physics, same work)
    Bd, dBd = dense.born_radii(dense.born(x1))
    _, cd = dense.gb_terms(Bd, dBd, dense.energy_rows(x1, Bd)[1])
    out["dense_born_ms"] = _cuda_ms(lambda: dense.born(x1), 5)
    out["dense_energy_ms"] = _cuda_ms(lambda: dense.energy_rows(x1, Bd), 5)
    out["dense_force_ms"] = _cuda_ms(lambda: dense.pair_forces(x1, Bd, cd), 5)
    out["dense_eval_ms"] = _cuda_ms(lambda: dense(x1), 5)
    _line("phase 15 large kernels", out)
    out["system"], out["x_min"] = system, x_min
    return out


def phase_bonded(large: dict) -> dict:
    """``csrc/bonded.cu`` against its plain version and float64 autograd."""
    from pmarlo_tpu_torch.md.bonded_window import build_bonded_window
    from pmarlo_tpu_torch.md.forces import angle_energy, bond_energy, torsion_energy

    system, x_min = large["system"], large["x_min"]
    N = system.n_atoms
    fn = build_bonded_window(system)
    out = {"atoms": N, "bonds": int(system.bond_idx.shape[0]),
           "angles": int(system.angle_idx.shape[0]),
           "torsions": int(system.torsion_idx.shape[0]),
           "incidences": fn.incidences, "far_terms": fn.far_terms}
    f64 = torch.float64
    for tag, x in (("r1", _noisy(x_min, 1, seed=23, sigma=0.01)),
                   ("r3", _noisy(x_min, 3, seed=24, sigma=0.01))):
        e, g = fn(x, energy_dtype=f64)
        ep, gp = fn.reference(x, energy_dtype=f64)
        s64 = dataclasses.replace(system, **{
            f.name: getattr(system, f.name).double() for f in dataclasses.fields(system)
            if isinstance(getattr(system, f.name), torch.Tensor)
            and getattr(system, f.name).is_floating_point()})
        y = x.double().requires_grad_(True)
        ea = bond_energy(s64, y) + angle_energy(s64, y) + torsion_energy(s64, y)
        (ga,) = torch.autograd.grad(ea.sum(), y)
        e2, g2 = fn(x, energy_dtype=f64)
        torch.cuda.synchronize()
        _gate(out, f"{tag}_vs_plain", e, g, ep, gp)
        _gate(out, f"{tag}_vs_autograd", e, g, ea.detach(), ga)
        out[f"{tag}_two_launches_bitwise_equal"] = torch.equal(e, e2) and torch.equal(g, g2)
        _check(out[f"{tag}_two_launches_bitwise_equal"], "bonded kernel reproducible")
        if tag == "r1":
            out["grad_max_abs_err"] = float((g - gp).abs().max())
            x1 = x
    out["bonded_graph_ms"] = _graph_ms(lambda: fn(x1))
    out["bonded_ms"] = _cuda_ms(lambda: fn(x1), 50)
    out["bonded_plain_ms"] = _cuda_ms(lambda: fn.reference(x1), 5)
    out.update(_bonded_bound(system))
    _line("phase 16 bonded", out)
    return out


def phase_large_path() -> dict:
    """The large implicit-solvent path at full width, 61,824 atoms.

    The temperature gate is not on ``run_md``'s reported kinetic/target
    ratio over the second half (printed as
    ``reported_kinetic_over_target_second_half``; it reads ~0.88 at 4 fs and
    stays there) but on the state's mid-step velocities at 2.0 and 2.6 ps
    (``kinetic_over_target_state_by_ps``), in [0.9, 1.1]: the reported
    velocities carry the trailing half kick, and that on-step kinetic energy
    is low by a share that grows as dt^2 (``temperature_study`` measures it).
    """
    from pmarlo_tpu_torch.md.constraints import (build_h_constraints, constraint_violation,
                                                 strip_constrained_bonded)
    from pmarlo_tpu_torch.md.integrate import instantaneous_temperature, run_md, thermalize
    from pmarlo_tpu_torch.md.minimize import minimize_energy
    from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn, kernel_name

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    system, x0 = _large_system(LARGE_COPIES)
    t1 = time.perf_counter()
    cut = dict(tile=LARGE_TILE, gb_cutoff=GB_CUTOFF, order_from=x0)
    fn = build_pair_force_fn(system, **cut)
    spec = build_h_constraints(system)
    md_system = strip_constrained_bonded(system)
    fn_md = build_pair_force_fn(md_system, **cut)
    t2 = time.perf_counter()
    _check(fn.mode == fn_md.mode == "newton" and fn.bonded == fn_md.bonded == "window",
           "the large path defaults to the Newton sweeps and the bonded kernel")
    N = system.n_atoms
    out = {"atoms": N, "constraints": spec.n_constraints, "dt_ps": LARGE_DT_PS,
           "tiles": fn.n_tiles, "system_build_s": t1 - t0, "force_fn_build_s": t2 - t1}
    x_min, e_min = minimize_energy(system, x0, force_fn=fn, max_iterations=LARGE_FIRE)
    torch.cuda.synchronize()
    out["minimize_s"] = time.perf_counter() - t2
    out["energy_start_kj_mol"] = float(fn(x0)[0])
    out["energy_minimized_kj_mol"] = float(e_min)
    close = fn.close_tiles(fn.to_storage(x_min[None]))
    out["tile_block_share"] = float(close.float().mean())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    kw = dict(dt=LARGE_DT_PS, friction=1.0, temperature_K=300.0, constraints=spec)
    state = thermalize(system, x_min, gen, 300.0)
    state, _ = run_md(system, state, n_steps=LARGE_WARM_STEPS, force_fn=fn_md,
                      report_interval=LARGE_WARM_STEPS, **kw)
    # the timed stretch in four segments: run_md reports temperatures from
    # velocities shifted by the trailing half kick, which at 4 fs read ~10%
    # low (the on-step kinetic energy of a BAOAB step is low by (w dt)^2 / 4 a
    # mode); the state's own mid-step velocities, read at each segment's end,
    # are the thermostat's temperature, as ReplicaExchange.run reports it
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    segments, state_ratio = [], []
    for _ in range(4):
        state, seg = run_md(system, state, n_steps=LARGE_STEPS // 4, force_fn=fn_md,
                            report_interval=50, **kw)
        segments.append(seg)
        state_ratio.append(float(instantaneous_temperature(
            system, state.velocities, spec.n_constraints) / 300.0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t3
    frames = {k: torch.cat([seg[k] for seg in segments]) for k in segments[0]}
    counts = _counts()
    half = frames["temperature"].shape[0] // 2
    out.update({
        "steps": LARGE_STEPS,
        "ms_per_step": wall / LARGE_STEPS * 1e3,
        "ns_per_day": LARGE_STEPS * LARGE_DT_PS * 1e-3 * 86_400.0 / wall,
        "reported_kinetic_over_target_second_half": float(
            frames["temperature"][half:].mean() / 300.0),
        "kinetic_over_target_state_by_ps": state_ratio,
        "reported_kinetic_over_target_frames": [float(t / 300.0)
                                                for t in frames["temperature"]],
        "max_constraint_deviation_nm": float(constraint_violation(spec, frames["positions"])),
        "frames_finite": bool(torch.isfinite(frames["positions"]).all()),
        "launches": {k: v for k, v in counts.items() if v},
    })
    # one evaluation a FIRE iteration, the minimizer's final energy and the
    # start energy above; one a step and one a report
    evals = (LARGE_FIRE + 2 + LARGE_WARM_STEPS + 1 + LARGE_STEPS + LARGE_STEPS // 50)
    newton = [kernel_name(s, "newton") for s in ("born", "energy", "force")]
    _check(all(counts[k] == evals for k in newton) and counts["bonded"] == evals,
           f"large-path launches {out['launches']}, expected {evals} of each")
    _check(set(out["launches"]) == set(newton) | {"bonded"},
           f"the large path launched other kernels: {out['launches']}")
    _check(out["frames_finite"], "large-path frames finite")
    _check(bool(torch.isfinite(frames["potential_energy"]).all()), "large-path energies finite")
    _check(out["max_constraint_deviation_nm"] <= 1e-4,
           f"large-path constraint deviation {out['max_constraint_deviation_nm']}")
    out["eval_ms"] = _cuda_ms(lambda: fn_md(state.positions), 10)

    # the same run through the ordered culled sweeps
    fn_ord = build_pair_force_fn(md_system, newton=False, **cut)
    torch.cuda.synchronize()
    _reset_counts()
    t4 = time.perf_counter()
    state_o, frames_o = run_md(system, state, n_steps=LARGE_ORDERED_STEPS, force_fn=fn_ord,
                               report_interval=LARGE_ORDERED_STEPS, **kw)
    torch.cuda.synchronize()
    out["ordered_ms_per_step"] = (time.perf_counter() - t4) / LARGE_ORDERED_STEPS * 1e3
    counts_o = _counts()
    out["ordered_launches"] = {k: v for k, v in counts_o.items() if v}
    culled = [kernel_name(s, "culled") for s in ("born", "energy", "force")]
    _check(all(counts_o[k] == LARGE_ORDERED_STEPS + 1 for k in culled)
           and set(out["ordered_launches"]) == set(culled) | {"bonded"},
           f"ordered-path launches {out['ordered_launches']}")
    _check(bool(torch.isfinite(frames_o["positions"]).all()), "ordered-path frames finite")
    out["ordered_eval_ms"] = _cuda_ms(lambda: fn_ord(state.positions), 10)
    e_n, f_n = fn_md(state.positions)
    e_o, f_o = fn_ord(state.positions)
    _gate(out, "newton_vs_ordered", e_n, f_n, e_o, f_o)
    out["peak_device_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # every kernel of the path against its plain version at the path's own
    # shapes (both counts are read: these launches are not the path's): the
    # stripped system, 483 full tiles, the positions the run arrived at
    x_end = state.positions.reshape(1, N, 3)
    xs = fn_ord.to_storage(x_end)
    close = fn_ord.close_tiles(xs)
    visited, within, near = _visited_within(fn_ord, xs, close)
    out.update({"end_tile_block_share": float(close.float().mean()),
                "end_pairs_within_cutoff": within,
                "end_born_near_directions": near,
                "end_pairs_within_share_of_visited": within / visited})
    for mode, f in (("newton", fn_md), ("culled", fn_ord)):
        B, c = _sweeps_vs_plain(out, mode, f, x_end, max_abs=True)
        _time_sweeps(out, mode, f, xs, B, c, close, within, near)
    # the ordered sweeps: bit-reproducible, alone on the card, their walk
    for tag, sweep in (("born", lambda: (fn_ord.born(xs, close),)),
                       ("energy", lambda: fn_ord.energy_rows(xs, B, close)),
                       ("force", lambda: (fn_ord.pair_forces(xs, B, c, close),))):
        same = all(torch.equal(u, v) for u, v in zip(sweep(), sweep()))
        out[f"culled_{tag}_two_launches_bitwise_equal"] = same
        _check(same, f"ordered {tag} sweep reproducible")
        out[f"culled_{tag}_graph_ms"] = _graph_ms(sweep)
    out["culled_walk_host_replay"] = _ordered_walk(fn_ord, xs, close)
    _check(out["culled_walk_host_replay"]["pairs_queued"] == within,
           f"the ordered walk queues {out['culled_walk_host_replay']} of {within} pairs")
    out["tile_table_ms"] = _cuda_ms(lambda: fn_ord.close_tiles(xs), 20)
    out["newton_patch_list_ms"] = _cuda_ms(lambda: fn_md.patch_list(xs, close), 20)
    bonded = fn_md._bonded_kernel
    e_b, g_b = bonded(x_end, energy_dtype=torch.float64)
    e_p, g_p = bonded.reference(x_end, energy_dtype=torch.float64)
    _gate(out, "bonded_vs_plain", e_b, g_b, e_p, g_p)
    out["bonded_incidences"] = bonded.incidences
    out["bonded_grad_max_abs_err"] = float((g_b - g_p).abs().max())
    e_b2, g_b2 = bonded(x_end, energy_dtype=torch.float64)
    out["bonded_two_launches_bitwise_equal"] = torch.equal(e_b, e_b2) and torch.equal(g_b, g_b2)
    _check(out["bonded_two_launches_bitwise_equal"], "bonded kernel reproducible at 61,824 atoms")
    out["bonded_graph_ms"] = _graph_ms(lambda: bonded(x_end))
    out["bonded_ms"] = _cuda_ms(lambda: bonded(x_end), 50)
    out["bonded_plain_ms"] = _cuda_ms(lambda: bonded.reference(x_end), 5)
    bound = _bonded_bound(md_system)
    out["bonded_bound_ms"], out["bonded_bound_by"] = bound["bound_ms"], bound["bound_by"]
    out["peak_device_memory_with_plain_gib"] = torch.cuda.max_memory_allocated() / 2**30
    _line("phase 17 large path", out)
    # thermalized at a minimum, half the kinetic energy goes into the potential
    # within ~0.1 ps and the thermostat (1/ps) brings it back over picoseconds:
    # the gate is on the state's temperature 2.0 and 2.6 ps in
    late = 0.5 * (state_ratio[2] + state_ratio[3])
    _check(0.9 <= late <= 1.1, f"large-path kinetic/target {state_ratio}")
    return out


def _pme_oracle(system, fn, x: torch.Tensor, box: torch.Tensor):
    """Dense float64 energy and forces of ``system`` with smooth PME at
    ``x (N, 3)`` in ``box``: the terms of ``md/pme.py ewald_energy_dense``
    (dense real space, mesh, self, background) on ``fn``'s mesh and spline
    order, the excluded and 1-4 pairs out of the real space and corrected
    to their scaled bare Coulomb, and the LJ and bonded terms by autograd
    of the dense periodic energy with the charges zeroed. Virtual sites are
    expanded from their parents inside the autograd, so the forces on the
    parents hold the spread and the site rows get none."""
    from pmarlo_tpu_torch.md import pme
    from pmarlo_tpu_torch.md.vsites import VirtualSites, expanded_energy_and_forces

    b = tuple(float(v) for v in box.cpu().double())
    sys_b = dataclasses.replace(system, box=b)
    q = system.charges.double()
    se = system.scale_elec.double()
    i, j = torch.triu(se < 1.0, diagonal=1).nonzero(as_tuple=True)
    alpha, rc = fn.phys.alpha, fn.phys.rc
    vs = VirtualSites.from_system(system)
    with torch.enable_grad():
        x64 = x.detach().double().requires_grad_(True)
        y = x64 if vs is None else vs.expand(x64)
        e = (pme.real_space_energy_dense(y, q, b, rc, alpha, exclude_mask=(se < 1.0).double())
             + pme.reciprocal_energy(y, q, b, alpha, fn.pme_mesh_shape, fn.pme_order)
             + pme.excluded_pair_correction(y, q, b, alpha, i, j, se[i, j])
             + pme.self_energy(q, alpha) + pme.background_energy(q, b, alpha))
        (g,) = torch.autograd.grad(e, x64)
    e_lj, f_lj = expanded_energy_and_forces(
        dataclasses.replace(sys_b, charges=torch.zeros_like(system.charges)), x.double())
    return e.detach() + e_lj, f_lj - g


def _sites_off_parents(system, frames: torch.Tensor) -> float:
    """Largest distance (nm) of a virtual-site row of ``frames (..., N, 3)``
    from the position its parents define."""
    from pmarlo_tpu_torch.md.vsites import VirtualSites

    vs = VirtualSites.from_system(system)
    return float((vs.expand(frames) - frames).abs().max())


def _npt_segment(out: dict, tag: str, res: dict, wall: float, steps: int,
                 setup_s: Optional[float] = None) -> None:
    """The numbers of a ``run_segment`` NPT result under ``tag``; with the
    set-up's seconds (a resume: no minimization) ms a step and ns/day."""
    T = res["temperature"].double()
    if setup_s is not None:
        out.update({
            f"{tag}_setup_s": setup_s,
            f"{tag}_ms_per_step": (wall - setup_s) / steps * 1e3,
            f"{tag}_ns_per_day": steps * DT_PS * 1e-3 * 86_400.0 / (wall - setup_s),
        })
    out.update({
        f"{tag}_steps": steps,
        f"{tag}_wall_s": wall,
        f"{tag}_acceptance": res["barostat_acceptance"],
        f"{tag}_density_g_cm3": res["density_g_cm3"].tolist(),
        f"{tag}_box_nm": res["box"].tolist(),
        f"{tag}_kinetic_over_target_second_half": float(T[T.shape[0] // 2:].mean() / 300.0),
        f"{tag}_kinetic_over_target_by_frame": (T / 300.0).tolist(),
    })


def phase_production_segment() -> dict:
    """``run_segment(nonbonded="pme", ensemble="npt")`` on the shipped
    solvated chignolin at full size, resumed, and held against its plain
    version, a dense oracle and a fresh build at the final box."""
    import tempfile

    from pmarlo_tpu_torch import run_segment
    from pmarlo_tpu_torch.io.cif import read_structure
    from pmarlo_tpu_torch.io.trajectory import TrajectoryReader
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn
    from pmarlo_tpu_torch.md.constraints import constraint_violation
    from pmarlo_tpu_torch.md.forcefield import build_system
    from pmarlo_tpu_torch.md.setup import build_explicit_setup

    structure = read_structure(SOLVATED_PDB)
    kw = dict(nonbonded="pme", ensemble="npt", dt_ps=DT_PS, report_interval=SEGMENT_REPORT,
              barostat_interval=BAROSTAT_INTERVAL, cutoff=EXPLICIT_CUTOFF,
              friction_per_ps=SHORT_RUN_FRICTION, device="cuda")
    out = {"box_start_nm": list(structure.box)}
    with tempfile.TemporaryDirectory() as tmp:
        traj = f"{tmp}/traj.xtc"
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = run_segment(SOLVATED_PDB, n_steps=SEGMENT_STEPS, seed=18, output_file=traj,
                          minimize_iterations=SEGMENT_FIRE, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        # the set-up of a segment (a resume builds no minimizer) timed alone
        t0 = time.perf_counter()
        setup = build_explicit_setup(structure, box=tuple(res["final_box"].tolist()),
                                     nonbonded="pme", require_cells=True,
                                     dispersion_correction=True, build_minimize_fn=False,
                                     device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        _reset_counts()
        t0 = time.perf_counter()
        res2 = run_segment(SOLVATED_PDB, n_steps=SEGMENT_RESUME_STEPS,
                           initial_state=res["final_state"],
                           initial_barostat_state=res["final_barostat_state"], **kw)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        resume_counts = _counts()
        frames = TrajectoryReader(traj).load()
    system = res["system"]
    N = system.n_atoms
    out.update({"atoms": N, "launches": counts["cell_force"] + resume_counts["cell_force"]})
    _npt_segment(out, "segment", res, wall, SEGMENT_STEPS)
    _npt_segment(out, "resume", res2, wall2, SEGMENT_RESUME_STEPS, setup_s)
    # ms a step from the resume, which neither minimizes nor thermalizes;
    # the segment's set-up and minimization are the rest of its wall
    out["ms_per_step"] = out["resume_ms_per_step"]
    out["ns_per_day"] = out["resume_ns_per_day"]
    out["segment_setup_minimize_s"] = wall - SEGMENT_STEPS * out["ms_per_step"] * 1e-3
    spec = setup.constraints
    out["max_constraint_deviation_nm"] = max(
        float(constraint_violation(spec, r["positions"])) for r in (res, res2))
    out["xtc_max_abs_err_nm"] = float(np.abs(frames - res["positions"].cpu().numpy()).max())
    bs = res2["final_barostat_state"]
    _check(counts["cell_force"] > 0 and resume_counts["cell_force"] > 0,
           "the segment went through the cell kernel")
    _check(counts["periodic_force"] == 0 and counts["fused_md_chunk"] == 0,
           f"the segment launched other kernels {counts}")
    _check(res["positions"].is_cuda and res["box"].is_cuda, "the segment's frames on the card")
    for r in (res, res2):
        _check(bool(torch.isfinite(r["positions"]).all()), "segment frames finite")
        _check(bool(torch.isfinite(r["potential_energy"]).all()), "segment energies finite")
    _check(0.0 < out["segment_acceptance"] < 1.0,
           f"barostat acceptance {out['segment_acceptance']}")
    _check(bs.n_attempted == (SEGMENT_STEPS + SEGMENT_RESUME_STEPS) // BAROSTAT_INTERVAL,
           f"the resumed move stream counted {bs.n_attempted}")
    _check(0.95 <= out["segment_kinetic_over_target_second_half"] <= 1.05,
           f"segment T {out['segment_kinetic_over_target_second_half']}")
    _check(out["max_constraint_deviation_nm"] <= 1e-4,
           f"segment constraints {out['max_constraint_deviation_nm']}")
    _check(frames.shape == tuple(res["positions"].shape), "the .xtc holds every frame")
    _check(out["xtc_max_abs_err_nm"] <= 0.5e-3 + 1e-6, "the .xtc frames read back")

    # at the final positions and box: the kernel, its plain version, the
    # dense oracle and a fresh build at that box (the unshifted real space of
    # the exact-Ewald oracle)
    x = res2["positions"][-1]
    box = res2["box"][-1]
    # the step's force call alone (the rest of a step: the integrator and
    # SHAKE / RATTLE of the rigid waters and the X-H bonds)
    md_fn = setup.md_force_fn
    out["step_eval_ms"] = _cuda_ms(lambda: md_fn.apply_dynamic(x, None, box), 20)
    out["step_eval_share"] = out["step_eval_ms"] / out["ms_per_step"]
    fn = build_cell_force_fn(system, electrostatics="pme", ewald_shift=False)
    e, f = fn.dynamic(x, box)
    er, fr = fn.reference(x, box)
    eo, fo = _pme_oracle(system, fn, x, box)
    _gate(out, "final_kernel_vs_plain", e, f, er, fr)
    _gate(out, "final_kernel_vs_oracle", e, f, eo, fo)
    _gate(out, "final_plain_vs_oracle", er, fr, eo, fo)
    fresh_sys, _ = build_system(structure, box=tuple(float(b) for b in box.cpu()),
                                cutoff=EXPLICIT_CUTOFF, device="cuda")
    fresh = build_cell_force_fn(fresh_sys, electrostatics="pme", ewald_shift=False)
    # the grid may gain a cell layer (2.68 nm is near 3 x 0.9), which
    # changes the decomposition and not the energy; the mesh must be the same
    out["fresh_build_grid"] = [fresh.grid.nx, fresh.grid.ny, fresh.grid.nz]
    _check(fresh.pme_mesh_shape == fn.pme_mesh_shape, "the final box keeps the mesh")
    ef, ff = fresh(x)
    _gate(out, "final_dynamic_vs_fresh_build", e, f, ef, ff)
    out["grid"] = [fn.grid.nx, fn.grid.ny, fn.grid.nz]
    out["pme_mesh_shape"] = list(fn.pme_mesh_shape)
    _line("phase 18 production segment", out)
    return out


def _pme_split(fn, x: torch.Tensor, box: torch.Tensor, reps: int = 20) -> dict:
    """ms of the parts of one NPT PME evaluation (CUDA events around
    ``reps`` calls of each part)."""
    from pmarlo_tpu_torch.md import pme
    from pmarlo_tpu_torch.md.cells import bin_atoms

    xb = x[None]
    order, cell_start, _, xw = bin_atoms(fn.grid, xb, box)
    order, cell_start = order.contiguous(), cell_start.contiguous()
    shifts = fn.box_shifts(box)
    mesh = fn.mesh

    def spread():
        with torch.enable_grad():
            y = xb.detach().requires_grad_(True)
            return y, pme.spread_charges(y, fn._q, box, mesh.shape, mesh.order)

    def fft(Q):
        with torch.enable_grad():
            F = torch.fft.rfftn(Q, dim=(-3, -2, -1))
            infl, pref = mesh._traced_influence(box, None)
            return pref * (infl * (F.real * F.real + F.imag * F.imag)).sum((-3, -2, -1))

    y, Q = spread()
    e = fft(Q)
    return {
        "binning_ms": _cuda_ms(lambda: bin_atoms(fn.grid, xb, box), reps),
        "sweep_ms": _cuda_ms(lambda: fn.sweep(xw, order, cell_start, shifts), reps),
        "band_correction_ms": _cuda_ms(lambda: fn.correction(xb, box), reps),
        "spread_ms": _cuda_ms(spread, reps),
        "fft_ms": _cuda_ms(lambda: fft(Q), reps),
        "gather_ms": _cuda_ms(lambda: torch.autograd.grad(e.sum(), y, retain_graph=True), reps),
        "eval_ms": _cuda_ms(lambda: fn.dynamic(x, box), reps),
    }


def phase_pme_water() -> dict:
    """``run_segment(nonbonded="pme", ensemble="npt")`` on the 27,783-atom
    water box, the parts of an evaluation, run to run, and a volume move into
    a box below the cutoff cover."""
    import tempfile
    import warnings

    from pmarlo_tpu_torch import run_segment
    from pmarlo_tpu_torch.data.water import water_box_structure
    from pmarlo_tpu_torch.md import barostat
    from pmarlo_tpu_torch.md.setup import build_explicit_setup

    structure, box0 = water_box_structure(WATER_SIDE)
    atoms = [a for r in structure.residues for a in r.atoms]
    kw = dict(nonbonded="pme", ensemble="npt", dt_ps=DT_PS, report_interval=PME_WATER_REPORT,
              barostat_interval=BAROSTAT_INTERVAL, cutoff=EXPLICIT_CUTOFF, device="cuda")
    out = {"atoms": len(atoms)}
    with tempfile.TemporaryDirectory() as tmp:
        pdb = _write_pdb(f"{tmp}/water.pdb", structure, box0)
        _reset_counts()
        warm = run_segment(pdb, n_steps=PME_WATER_WARM_STEPS, seed=19,
                           minimize_iterations=PME_WATER_FIRE, **kw)
        torch.cuda.synchronize()
        launches = _counts()["cell_force"]
        t0 = time.perf_counter()
        setup = build_explicit_setup(structure, box=tuple(warm["final_box"].tolist()),
                                     nonbonded="pme", require_cells=True,
                                     dispersion_correction=True, build_minimize_fn=False,
                                     device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = run_segment(pdb, n_steps=PME_WATER_STEPS, initial_state=warm["final_state"],
                          initial_barostat_state=warm["final_barostat_state"], **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches += _counts()["cell_force"]
    _npt_segment(out, "npt", res, wall, PME_WATER_STEPS, setup_s)
    out["ms_per_step"] = out["npt_ms_per_step"]
    out["peak_device_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["warm_density_g_cm3"] = warm["density_g_cm3"].tolist()
    out["launches"] = launches
    dens = torch.cat([warm["density_g_cm3"], res["density_g_cm3"]])
    _check(bool(torch.isfinite(res["positions"]).all()), "water-box NPT frames finite")
    _check(bool(((dens >= 0.9) & (dens <= 1.05)).all()), f"water-box density {dens.tolist()}")
    _check(0.0 <= out["npt_acceptance"] <= 1.0, f"acceptance {out['npt_acceptance']}")
    _check(launches > 0, "the water box went through the cell kernel")

    fn = setup.md_force_fn
    x = res["positions"][-1]
    box = res["box"][-1]
    out.update(_pme_split(fn, x, box))
    e1, f1 = fn.dynamic(x, box)
    e2, f2 = fn.dynamic(x, box)
    torch.cuda.synchronize()
    out["run_to_run_force_rel"] = _rel(f2, f1)
    out["run_to_run_energy_rel"] = _rel(e2.double(), e1.double())
    out["run_to_run_force_max_abs"] = float((f2 - f1).abs().max())
    _check(out["run_to_run_force_rel"] <= 1e-4, "PME forces run to run")
    _check(out["run_to_run_energy_rel"] <= 1e-5, "PME energy run to run")

    # a move into a box whose cell layers are thinner than the cutoff: the
    # energy there is NaN and the move is rejected, with no host read
    system = setup.system
    ids = barostat.molecule_ids(system)
    move = barostat.make_volume_move(lambda xx, bb: fn.dynamic(xx, bb)[0], ids, system.masses,
                                     int(ids.max()) + 1, pressure_bar=1.0,
                                     temperature_K=300.0)
    bs = res["final_barostat_state"]
    move(x, bs)                                   # copies the molecule tables once
    # the scale that puts the thinnest cell layer 2% under the cutoff, and
    # the uniform that proposes it from a width of 90% of the volume
    edge = float((box.cpu() / torch.tensor([fn.grid.nx, fn.grid.ny, fn.grid.nz])).min())
    s = min(0.98 * EXPLICIT_CUTOFF / edge, 0.97)
    u_dv = (s**3 - 1.0) / 0.9
    bs = dataclasses.replace(bs, dv=torch.full_like(bs.dv, 0.9 * float(box.prod())))
    out["squeezed_cell_edge_nm"] = edge * s
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            x_new, bs1, accepted, e_now = move(x, bs, uniforms=(u_dv, 1e-6))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice ("a prototype feature ...") is no synchronisation
    syncs = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
    e_trial, _ = fn.dynamic(barostat.scale_positions(x, s, ids, system.masses,
                                                     int(ids.max()) + 1), box * s)
    out["squeezed_move_host_syncs"] = len(syncs)
    out["squeezed_energy"] = float(e_trial)
    _check(not syncs, f"the volume move synchronised with the host: {syncs[:3]}")
    _check(bool(torch.isnan(e_trial)), "the squeezed box's energy is NaN")
    _check(not bool(accepted) and torch.equal(bs1.box, bs.box) and torch.equal(x_new, x),
           "the move into the squeezed box is rejected")
    _check(bool(torch.isfinite(e_now)), "the rejected move reports the energy it kept")
    _line("phase 19 pme water", out)
    return out


def _write_pdb(path: str, structure, box) -> str:
    from pmarlo_tpu_torch.io.pdb import write_pdb

    atoms = [a for r in structure.residues for a in r.atoms]
    return write_pdb(path, structure.coordinates(), [a.name for a in atoms],
                     [a.resname for a in atoms], [a.resid for a in atoms], box=box)


def _water_rdf(frames: np.ndarray, boxes: np.ndarray, o_idx: np.ndarray) -> dict:
    """g(r) of the oxygens ``o_idx`` over ``frames (F, N, 3)``, each frame
    in its own box ``boxes (F, 3)``, the frames' g averaged; the first
    peak's position and height."""
    from pmarlo_tpu_torch.features.rdf import radial_distribution

    r_max = min(1.0, 0.5 * float(boxes.min()) - 1e-3)
    n_bins = int(round(r_max / 0.01))
    gs = []
    for x, b in zip(frames, boxes):
        r, g = radial_distribution(torch.as_tensor(x, device="cuda"),
                                   tuple(float(v) for v in b), o_idx, r_max=r_max,
                                   n_bins=n_bins)
        gs.append(g)
    g = np.mean(gs, axis=0)
    peak = int(np.argmax(g))
    return {"rdf_bin_nm": float(r[1] - r[0]), "rdf_g": [round(float(v), 4) for v in g],
            "rdf_frames": len(gs),
            "rdf_peak_nm": float(r[peak]), "rdf_peak_height": float(g[peak])}


def phase_tip4pew_segment() -> dict:
    """Virtual-site water on the production path: chignolin solvated in
    TIP4P-Ew through ``run_segment(nonbonded="pme", ensemble="npt")``,
    resumed; the row 9 kernel with the sites against its plain version and
    a dense float64 oracle through the expansion; g(r) and the MSD of the
    water oxygens from the .xtc."""
    import tempfile

    from pmarlo_tpu_torch import run_segment
    from pmarlo_tpu_torch.data.chignolin import chignolin_structure
    from pmarlo_tpu_torch.features.msd import diffusion_coefficient, mean_squared_displacement
    from pmarlo_tpu_torch.io.trajectory import TrajectoryReader
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn
    from pmarlo_tpu_torch.md.constraints import constraint_violation
    from pmarlo_tpu_torch.md.setup import build_explicit_setup
    from pmarlo_tpu_torch.md.vsites import VirtualSites, n_vsites
    from pmarlo_tpu_torch.protein import solvate_structure

    structure, box0 = solvate_structure(chignolin_structure(), padding=1.0,
                                        water_model="tip4pew")
    kw = dict(nonbonded="pme", ensemble="npt", dt_ps=DT_PS, report_interval=TIP4P_REPORT,
              barostat_interval=BAROSTAT_INTERVAL, cutoff=EXPLICIT_CUTOFF,
              friction_per_ps=TIP4P_FRICTION, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        pdb = _write_pdb(f"{tmp}/tip4pew.pdb", structure, box0)
        traj = f"{tmp}/tip4pew.xtc"
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = run_segment(pdb, n_steps=TIP4P_STEPS, seed=20, output_file=traj,
                          minimize_iterations=TIP4P_FIRE, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        t0 = time.perf_counter()
        setup = build_explicit_setup(pdb, box=tuple(res["final_box"].tolist()),
                                     nonbonded="pme", require_cells=True,
                                     dispersion_correction=True, build_minimize_fn=False,
                                     device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        _reset_counts()
        t0 = time.perf_counter()
        res2 = run_segment(pdb, n_steps=TIP4P_RESUME_STEPS, initial_state=res["final_state"],
                           initial_barostat_state=res["final_barostat_state"], **kw)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        resume_counts = _counts()
        frames = TrajectoryReader(traj).load()
    system = res["system"]
    out = {"atoms": system.n_atoms, "sites": n_vsites(system),
           "waters": sum(r.name == "HOH" for r in structure.residues),
           "box_start_nm": list(box0),
           "launches": counts["cell_force"] + resume_counts["cell_force"]}
    print(f"phase 20: {out['atoms']} rows, {out['sites']} TIP4P-Ew M sites", flush=True)
    _npt_segment(out, "segment", res, wall, TIP4P_STEPS)
    _npt_segment(out, "resume", res2, wall2, TIP4P_RESUME_STEPS, setup_s)
    out["ms_per_step"] = out["resume_ms_per_step"]
    out["ns_per_day"] = out["resume_ns_per_day"]
    T = torch.cat([res["temperature"], res2["temperature"]]).double()
    out["kinetic_over_target_by_frame"] = (T / 300.0).tolist()
    out["kinetic_over_target_second_half"] = float(T[T.shape[0] // 2:].mean() / 300.0)
    spec = setup.constraints
    out["max_constraint_deviation_nm"] = max(
        float(constraint_violation(spec, r["positions"])) for r in (res, res2))
    out["sites_max_off_parents_nm"] = max(
        _sites_off_parents(system, r["positions"]) for r in (res, res2))
    dens = torch.cat([res["density_g_cm3"], res2["density_g_cm3"]])
    out["xtc_max_abs_err_nm"] = float(np.abs(frames - res["positions"].cpu().numpy()).max())
    _check(counts["cell_force"] > 0 and resume_counts["cell_force"] > 0,
           "the TIP4P-Ew segment went through the cell kernel")
    _check(counts["periodic_force"] == 0 and counts["fused_md_chunk"] == 0,
           f"the TIP4P-Ew segment launched other kernels {counts}")
    for r in (res, res2):
        _check(bool(torch.isfinite(r["positions"]).all()), "TIP4P-Ew frames finite")
        _check(bool(torch.isfinite(r["potential_energy"]).all()), "TIP4P-Ew energies finite")
    _check(out["sites_max_off_parents_nm"] <= SITE_ATOL_NM,
           f"TIP4P-Ew sites off their parents by {out['sites_max_off_parents_nm']} nm")
    _check(out["max_constraint_deviation_nm"] <= 1e-4,
           f"TIP4P-Ew constraints {out['max_constraint_deviation_nm']}")
    _check(0.95 <= out["kinetic_over_target_second_half"] <= 1.05,
           f"TIP4P-Ew T {out['kinetic_over_target_second_half']}")
    _check(bool(((dens >= 0.9) & (dens <= 1.05)).all()), f"TIP4P-Ew density {dens.tolist()}")
    _check(0.0 < out["segment_acceptance"] < 1.0,
           f"TIP4P-Ew barostat acceptance {out['segment_acceptance']}")
    _check(out["xtc_max_abs_err_nm"] <= 0.5e-3 + 1e-6, "the TIP4P-Ew .xtc frames read back")

    # at the final positions and box: the kernel with the sites, its plain
    # version and the dense float64 oracle through the expansion
    x = res2["positions"][-1]
    box = res2["box"][-1]
    md_fn = setup.md_force_fn
    vs = VirtualSites.from_system(system)
    xb = x[None]
    f_any = torch.randn_like(xb)
    out["step_eval_ms"] = _cuda_ms(lambda: md_fn.apply_dynamic(x, None, box), 20)
    out["expand_ms"] = _cuda_ms(lambda: vs.expand(xb), 50)
    out["spread_ms"] = _cuda_ms(lambda: vs.spread(f_any, xb), 50)
    out["site_share_of_step"] = (out["expand_ms"] + out["spread_ms"]) / out["ms_per_step"]
    fn = build_cell_force_fn(system, electrostatics="pme", ewald_shift=False)
    _reset_counts()
    e, f = fn.dynamic(x, box)
    er, fr = fn.reference(x, box)
    eo, fo = _pme_oracle(system, fn, x, box)
    sites = system.vsite_idx[:, 0].long()
    phys = torch.ones(system.n_atoms, dtype=torch.bool, device=x.device)
    phys[sites] = False
    _gate(out, "final_kernel_vs_plain", e, f[phys], er, fr[phys])
    _gate(out, "final_kernel_vs_oracle", e, f[phys], eo, fo[phys])
    _check(bool((f[sites] == 0.0).all()) and bool((fo[sites] == 0.0).all()),
           "forces on the M rows after the spread")
    _check(_counts()["cell_force"] == 1, "one launch for the kernel's evaluation")
    out["grid"] = [fn.grid.nx, fn.grid.ny, fn.grid.nz]
    out["pme_mesh_shape"] = list(fn.pme_mesh_shape)

    # the water model's checks from the trajectory file
    o_idx = np.asarray([i for i, (n, rn) in enumerate(zip(system.atom_names,
                                                           system.residue_names))
                        if n == "O" and rn == "HOH"])
    boxes = res["box"].cpu().numpy()
    half = frames.shape[0] // 2
    out.update(_water_rdf(frames[half:], boxes[half:], o_idx))
    masses = system.masses.double().cpu().numpy()
    lags, msd = mean_squared_displacement(torch.as_tensor(frames, device="cuda"),
                                          tuple(float(b) for b in boxes.mean(0)), o_idx,
                                          remove_com=True, masses=masses)
    out["oxygen_diffusion_cm2_s"] = diffusion_coefficient(
        lags, msd, TIP4P_REPORT * DT_PS) * 1e-2
    _check(RDF_PEAK_NM[0] <= out["rdf_peak_nm"] <= RDF_PEAK_NM[1],
           f"TIP4P-Ew O-O first peak at {out['rdf_peak_nm']} nm")
    _check(out["rdf_peak_height"] > RDF_PEAK_MIN,
           f"TIP4P-Ew O-O first peak height {out['rdf_peak_height']}")
    _line("phase 20 tip4pew segment", out)
    return out


def phase_tip5p_box() -> dict:
    """1,000 TIP5P waters through ``run_segment(nonbonded="dense")``:
    row 8 against its plain version with the out-of-plane sites, NVE
    drift with the site-free degrees of freedom, the sites on their
    parents."""
    import tempfile

    from pmarlo_tpu_torch import run_segment
    from pmarlo_tpu_torch.constants import BOLTZMANN_CONSTANT_KJ_PER_MOL
    from pmarlo_tpu_torch.data.water import water_box_structure
    from pmarlo_tpu_torch.md.constraints import build_h_constraints, constraint_violation
    from pmarlo_tpu_torch.md.forcefield import build_system
    from pmarlo_tpu_torch.md.periodic_force import build_periodic_force_fn
    from pmarlo_tpu_torch.md.vsites import n_vsites

    structure, box = water_box_structure(TIP5P_SIDE, water_model="tip5p", seed=21)
    system, x0 = build_system(structure, box=box, cutoff=EXPLICIT_CUTOFF, device="cuda")
    fn = build_periodic_force_fn(system)
    out = {"atoms": system.n_atoms, "sites": n_vsites(system), "box_nm": list(box)}
    print(f"phase 21: {out['atoms']} rows, {out['sites']} TIP5P L sites", flush=True)
    sites = system.vsite_idx[:, 0].long()

    def against_plain(tag, x):
        _reset_counts()
        e, f = fn(x)
        er, fr = fn.reference(x)
        _gate(out, tag, e, f, er, fr)
        _check(bool((f[sites] == 0.0).all()), f"{tag}: forces on the L rows")
        _check(_counts()["periodic_force"] == 1, f"{tag}: one launch")

    against_plain("start_kernel_vs_plain", x0)
    kw = dict(nonbonded="dense", dt_ps=DT_PS, report_interval=TIP5P_REPORT,
              cutoff=EXPLICIT_CUTOFF, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        pdb = _write_pdb(f"{tmp}/tip5p.pdb", structure, box)
        torch.cuda.synchronize()
        _reset_counts()
        warm = run_segment(pdb, n_steps=TIP5P_WARM_STEPS, seed=21,
                           minimize_iterations=TIP5P_FIRE, **kw)
        torch.cuda.synchronize()
        launches = _counts()["periodic_force"]
        _reset_counts()
        t0 = time.perf_counter()
        nve = run_segment(pdb, n_steps=TIP5P_NVE_STEPS, ensemble="nve",
                          initial_state=warm["final_state"], **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
    launches += counts["periodic_force"]
    spec = build_h_constraints(system)
    dof = 3 * (system.n_atoms - out["sites"]) - spec.n_constraints - 3
    kT = BOLTZMANN_CONSTANT_KJ_PER_MOL * 300.0
    e_tot = nve["total_energy"].double().cpu().numpy()
    t_ps = (np.arange(len(e_tot)) + 1) * TIP5P_REPORT * DT_PS
    slope = float(np.polyfit(t_ps, e_tot, 1)[0])
    out.update({
        "nve_steps": TIP5P_NVE_STEPS,
        "nve_wall_s": wall,
        "ms_per_step": wall / TIP5P_NVE_STEPS * 1e3,
        "degrees_of_freedom": dof,
        "nve_drift_kT_per_dof_per_ns": slope * 1e3 / (kT * dof),
        "nve_energy_span_kj_mol": float(e_tot.max() - e_tot.min()),
        "warm_kinetic_over_target": float(warm["temperature"].double().mean() / 300.0),
        "nve_kinetic_over_target": float(nve["temperature"].double().mean() / 300.0),
        "max_constraint_deviation_nm": max(
            float(constraint_violation(spec, r["positions"])) for r in (warm, nve)),
        "sites_max_off_parents_nm": max(
            _sites_off_parents(system, r["positions"]) for r in (warm, nve)),
        "launches": launches,
    })
    _check(counts["cell_force"] == 0 and counts["periodic_force"] > 0,
           f"the TIP5P box went through the dense kernel alone {counts}")
    for r in (warm, nve):
        _check(bool(torch.isfinite(r["positions"]).all()), "TIP5P frames finite")
    _check(bool(np.isfinite(e_tot).all()), "TIP5P NVE energies finite")
    _check(abs(out["nve_drift_kT_per_dof_per_ns"]) < NVE_DRIFT_MAX,
           f"TIP5P NVE drift {out['nve_drift_kT_per_dof_per_ns']} kT per dof per ns")
    _check(out["sites_max_off_parents_nm"] <= SITE_ATOL_NM,
           f"TIP5P sites off their parents by {out['sites_max_off_parents_nm']} nm")
    _check(out["max_constraint_deviation_nm"] <= 1e-4,
           f"TIP5P constraints {out['max_constraint_deviation_nm']}")
    against_plain("end_kernel_vs_plain", nve["positions"][-1])
    out["eval_ms"] = _cuda_ms(lambda: fn(nve["positions"][-1]), 20)
    out["sweep_ms"] = _cuda_ms(lambda: fn.sweep(nve["positions"][-1:]), 20)
    _line("phase 21 tip5p box", out)
    return out


# phase 22: the analysis half of the alanine pipeline
ANALYSIS_STATES = 16              # k-means states of the TICA coordinates (config 3)
ANALYSIS_LAG = 2                  # frames, as phase 4's MSM
ANALYSIS_ITS_LAGS = tuple(range(1, 11))
SYNTHETIC_ITS_LAGS = (1, 2, 5, 10, 20)   # at most 5: the reversible sampler is a loop


def _drunkards_walk(width: int = 8, height: int = 8, p_stay: float = 0.2) -> np.ndarray:
    """The 2-D lattice walk with reflecting walls of
    examples/11_tpt_drunkards_walk.py (BASELINE.json config 1)."""
    n = width * height
    T = np.zeros((n, n))
    for i in range(width):
        for j in range(height):
            s = i * height + j
            nbs = [b for b, ok in (((i - 1) * height + j, i > 0),
                                   ((i + 1) * height + j, i < width - 1),
                                   (i * height + j - 1, j > 0),
                                   (i * height + j + 1, j < height - 1)) if ok]
            T[s, s] = p_stay
            for b in nbs:
                T[s, b] = (1 - p_stay) / len(nbs)
    return T


def _its_gates(tag: str, its) -> None:
    med, lo, hi = its.timescales, its.ci_lower, its.ci_upper
    _check(bool(np.isfinite(med).all() and (med > 0).all()), f"{tag}: ITS medians {med}")
    _check(bool((lo <= med).all() and (med <= hi).all()), f"{tag}: ITS bands {lo} {med} {hi}")


def _tpt_gates(tag: str, T: np.ndarray, A, B) -> dict:
    """committors and reactive flux between ``A`` and ``B`` with their gates;
    the numbers of the flux and the largest |q+ + q- - 1| (0 for a
    reversible T)."""
    from pmarlo_tpu_torch.msm import committors, reactive_flux

    qp, qm = committors(T, A, B)
    tpt = reactive_flux(T, A, B)
    _check(bool((qp[A] == 0).all() and (qp[B] == 1).all()), f"{tag}: q+ on A and B")
    _check(bool(((qp >= 0) & (qp <= 1)).all() and ((qm >= 0) & (qm <= 1)).all()),
           f"{tag}: committors in [0, 1]")
    out_A, into_B = tpt.net_flux[A, :].sum(), tpt.net_flux[:, B].sum()
    _check(out_A > 0 and abs(out_A - into_B) <= 1e-8 * out_A,
           f"{tag}: flux out of A {out_A}, into B {into_B}")
    return {"total_flux": float(tpt.total_flux), "rate": float(tpt.rate),
            "mfpt": float(tpt.mfpt), "n_pathways": len(tpt.pathways),
            "committor_sum_off_1": float(np.abs(qp + qm - 1.0).max())}


def _pcca_sets(tag: str, T: np.ndarray):
    """PCCA+ into 2 macrostates, gated; their crisp sets."""
    from pmarlo_tpu_torch.msm import pcca_memberships

    chi = pcca_memberships(T, 2)
    _check(bool(((chi >= 0) & (chi <= 1)).all()), f"{tag}: memberships in [0, 1]")
    _check(float(np.abs(chi.sum(1) - 1.0).max()) <= 1e-8, f"{tag}: memberships sum to 1")
    crisp = chi.argmax(1)
    A, B = np.flatnonzero(crisp == 0), np.flatnonzero(crisp == 1)
    _check(len(A) > 0 and len(B) > 0, f"{tag}: two non-empty macrostates")
    return A, B


def phase_analysis_path(main: dict) -> dict:
    """Phase 22: TICA -> k-means -> MSM -> ITS (both posteriors) -> CK and
    the lag selector -> PCCA+ -> TPT -> FES on phase 4's REMD frames
    (config 3); the ITS ladder, PCCA+ and TPT on phase 4's synthetic
    35-shard set (config 5); TPT on the drunkard's-walk lattice (config 1).
    Host wall seconds of each step."""
    from pmarlo_tpu_torch.analysis.fes import compute_kde_fes
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.features import (TopologyInfo, compute_ramachandran,
                                           compute_ramachandran_fes)
    from pmarlo_tpu_torch.md.topology import build_topology
    from pmarlo_tpu_torch.msm import (build_msm, ck_test, compute_implied_timescales,
                                      counts_from_dtrajs, kmeans, reduce_features,
                                      sample_reversible_posterior)
    from pmarlo_tpu_torch.msm.ck_its_selector import select_optimal_lag_ck_its
    from pmarlo_tpu_torch.utils.msm_utils import ensure_connected_counts

    walls = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return result

    t_phase = time.perf_counter()
    res, feats = main["remd"], main["rung_features"]
    out = {}

    # 1. phi/psi of the four coldest rungs, against phase 4's cos/sin features
    info = TopologyInfo.from_topology(build_topology(alanine_dipeptide_structure()))
    angles = []
    for rung in range(4):
        traj = torch.as_tensor(res.positions[:, rung], dtype=torch.float32, device="cuda")
        phi, psi, labels = compute_ramachandran(traj, info, device="cuda")
        X = feats[rung]
        d_phi = (phi[:, 0] - np.degrees(np.arctan2(X[:, 2], X[:, 0])) + 180.0) % 360.0 - 180.0
        d_psi = (psi[:, 0] - np.degrees(np.arctan2(X[:, 3], X[:, 1])) + 180.0) % 360.0 - 180.0
        out[f"rung{rung}_phi_psi_vs_features_max_deg"] = float(
            max(np.abs(d_phi).max(), np.abs(d_psi).max()))
        _check(out[f"rung{rung}_phi_psi_vs_features_max_deg"] <= 1e-3,
               f"rung {rung}: compute_ramachandran vs phase 4's features")
        angles.append((phi[:, 0], psi[:, 0]))
    out["ramachandran_residues"] = labels

    # 2. TICA of the cos/sin features
    y, model = timed("tica_fit_s", lambda: reduce_features(
        feats, method="tica", lag=ANALYSIS_LAG, n_components=2, device="cuda"))
    ev = model.eigenvalues
    out["tica_eigenvalues"] = ev.tolist()
    _check(bool(((ev > -1.0) & (ev <= 1.0)).all() and (np.diff(ev) <= 0).all()),
           f"TICA eigenvalues {ev}")

    # 3. k-means to 16 states, the MSM at lag 2
    _, labels, _ = timed("kmeans_s", lambda: kmeans(
        np.concatenate(y), ANALYSIS_STATES, seed=0, device="cuda"))
    dtrajs = np.split(labels.astype(np.int64), np.cumsum([len(s) for s in y])[:-1])
    msm = timed("msm_s", lambda: build_msm(dtrajs, ANALYSIS_LAG, ANALYSIS_STATES))
    _check(float(np.abs(msm.transition_matrix.sum(1) - 1.0).max()) <= 1e-8,
           "MSM rows sum to 1")
    out["msm_active_states"] = int(len(msm.active_states))

    # 4. the ITS ladder, Dirichlet and reversible posteriors
    kw = dict(lags=ANALYSIS_ITS_LAGS, n_states=ANALYSIS_STATES, n_timescales=3, seed=0,
              device="cuda")
    its_d = timed("its_dirichlet_s", lambda: compute_implied_timescales(
        dtrajs, n_samples=100, **kw))
    its_r = timed("its_reversible_s", lambda: compute_implied_timescales(
        dtrajs, reversible=True, **kw))
    walls["its_reversible_per_lag_s"] = walls["its_reversible_s"] / len(ANALYSIS_ITS_LAGS)
    for tag, its in (("dirichlet", its_d), ("reversible", its_r)):
        _its_gates(f"config 3 {tag}", its)
        out[f"its_{tag}_timescales_frames"] = its.timescales.tolist()
        out[f"its_{tag}_plateau_lag"] = its.plateau_lag
    C, _ = ensure_connected_counts(counts_from_dtrajs(dtrajs, ANALYSIS_LAG, ANALYSIS_STATES))
    flows = sample_reversible_posterior(C, 16, return_flow=True, device="cuda")
    asym = max(float(np.abs(x - x.T).max() / np.abs(x).max()) for x in flows)
    out["reversible_flow_asymmetry"] = asym
    _check(asym <= 1e-6, f"reversible flow matrices asymmetric by {asym}")

    # 5. CK at factors 2 and 3, and the CK/ITS lag selector
    ck = timed("ck_s", lambda: ck_test(dtrajs, ANALYSIS_LAG, factors=(2, 3),
                                       n_states=ANALYSIS_STATES))
    _check(not ck.insufficient_data, "CK has both factors")
    out["ck_rms"] = {int(k): v for k, v in ck.rms.items()}
    sel = timed("selector_s", lambda: select_optimal_lag_ck_its(
        dtrajs, n_states=ANALYSIS_STATES, ck_factors=(2, 3)))
    out["selected_lag"] = int(sel.selected_lag)
    out["selector_lags"] = [e.lag for e in sel.evaluations]

    # 6. PCCA+ into 2 macrostates, TPT between them
    T = msm.restricted_T()
    A, B = timed("pcca_s", lambda: _pcca_sets("config 3", T))
    out["macrostate_sizes"] = [len(A), len(B)]
    out["tpt"] = timed("tpt_s", lambda: _tpt_gates("config 3", T, A, B))

    # 7. FES of the 300 K rung's phi/psi and of the two TICA coordinates
    rama = compute_ramachandran_fes(*angles[0], temperature_K=300.0)
    kde = timed("kde_fes_s", lambda: compute_kde_fes(
        np.concatenate(y)[:, 0], np.concatenate(y)[:, 1], temperature_K=300.0, device="cuda"))
    for tag, F, populated in (("ramachandran", rama["free_energy"], rama["histogram"] > 0),
                              ("kde", kde.free_energy, kde.counts > 0)):
        _check(bool(np.isfinite(F[populated]).all()), f"{tag} FES finite where populated")
        _check(float(np.nanmin(F)) == 0.0, f"{tag} FES minimum {np.nanmin(F)}")
        out[f"{tag}_fes_populated_share"] = float(populated.mean())

    # 8. the synthetic 35-shard set (config 5): ITS, PCCA+, TPT
    synth = main["synthetic"]
    skw = dict(lags=SYNTHETIC_ITS_LAGS, n_states=synth.n_states, seed=0, device="cuda")
    s_its_d = timed("synthetic_its_dirichlet_s", lambda: compute_implied_timescales(
        synth.dtrajs, n_samples=100, **skw))
    s_its_r = timed("synthetic_its_reversible_s", lambda: compute_implied_timescales(
        synth.dtrajs, reversible=True, **skw))
    walls["synthetic_its_reversible_per_lag_s"] = (
        walls["synthetic_its_reversible_s"] / len(SYNTHETIC_ITS_LAGS))
    for tag, its in (("dirichlet", s_its_d), ("reversible", s_its_r)):
        _its_gates(f"config 5 {tag}", its)
        out[f"synthetic_its_{tag}_slowest_frames"] = its.timescales[:, 0].tolist()
    Ts = synth.transition_matrix[np.ix_(synth.active_states, synth.active_states)]
    sA, sB = timed("synthetic_pcca_s", lambda: _pcca_sets("config 5", Ts))
    out["synthetic_tpt"] = timed("synthetic_tpt_s", lambda: _tpt_gates("config 5", Ts, sA, sB))

    # 9. the drunkard's walk (config 1), reversible: q+ + q- = 1
    out["lattice_tpt"] = timed("lattice_tpt_s", lambda: _tpt_gates(
        "lattice", _drunkards_walk(), [0], [63]))
    _check(out["lattice_tpt"]["committor_sum_off_1"] <= 1e-10, "lattice: q+ + q- = 1")

    walls["phase_s"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    _line("phase 22 analysis path", out)
    return out


CONFORMATION_CHECK_FRAMES = 64      # frames of phase 23 run again on the CPU
SASA_THRESHOLD_NM2 = 1e-6           # |d2 - r^2| of a point whose burial may flip
HBOND_THRESHOLD = 1e-6              # distance (nm) or cosine off its cutoff
SS_THRESHOLD_DEG = 1e-3             # phi / psi off a region boundary
KS_THRESHOLD_KCAL = 1e-4            # K&S energy off the -0.5 kcal/mol cutoff
DSSP_LETTERS = np.array(["C", "H", "E"])


def _sasa_point_margin(x: np.ndarray, radii: np.ndarray, i: int) -> float:
    """Least |d2 - r_j^2| (nm^2, float64, j != i) over atom i's 96 points:
    how close the closest of its burial tests sits to its threshold."""
    from pmarlo_tpu_torch.features.structure import _PROBE_RADIUS, _golden_spiral_points

    r = radii.astype(np.float32).astype(np.float64) + np.float32(_PROBE_RADIUS)
    x = x.astype(np.float64)
    pts = x[i] + r[i] * _golden_spiral_points(96)
    m = np.abs(((pts[:, None, :] - x[None]) ** 2).sum(-1) - r[None] ** 2)
    m[:, i] = np.inf
    return float(m.min())


def _sasa_agreement(tag: str, card: np.ndarray, cpu: np.ndarray, frames: np.ndarray,
                    radii: np.ndarray) -> dict:
    """Per-atom SASA of the card against the CPU: equal but for atoms with a
    point at its threshold (counted); the totals within 1e-4 relative."""
    differ = np.argwhere(card != cpu)
    margins = [_sasa_point_margin(frames[t], radii, i) for t, i in differ]
    rel = abs(float(card.sum()) - float(cpu.sum())) / float(cpu.sum())
    _check(all(m <= SASA_THRESHOLD_NM2 for m in margins),
           f"{tag}: SASA differs off a threshold, margins {margins[:8]}")
    _check(rel <= 1e-4, f"{tag}: SASA total {rel} relative off the CPU")
    return {"atoms_at_threshold": len(differ), "total_rel_err": rel,
            "max_abs_err_nm2": float(np.abs(card - cpu).max())}


def _hbond_margins(frames: np.ndarray, donors: np.ndarray, acceptors: np.ndarray) -> np.ndarray:
    """Per frame, the least distance (float64) of a donor-acceptor pair's H..A
    distance to 0.25 nm or of its angle cosine to cos 120 degrees."""
    if len(frames) == 0:
        return np.zeros(0)
    x = frames.astype(np.float64)
    ha = x[:, acceptors][:, None] - x[:, donors[:, 1]][:, :, None]
    dist = np.sqrt((ha ** 2).sum(-1) + 1e-12)
    hd = x[:, donors[:, 0]] - x[:, donors[:, 1]]
    hd /= np.sqrt((hd ** 2).sum(-1, keepdims=True) + 1e-12)
    cos = (hd[:, :, None] * ha / dist[..., None]).sum(-1)
    off = np.minimum(np.abs(dist - 0.25), np.abs(cos - np.cos(np.radians(120.0))))
    return off.reshape(len(x), -1).min(1)


def _ss_margins(frames: np.ndarray, info) -> np.ndarray:
    """Per frame, the least distance (degrees, float64) of a phi or psi to a
    boundary of ``ss_fractions``' regions."""
    if len(frames) == 0:
        return np.zeros(0)
    from pmarlo_tpu_torch.features import compute_dihedrals, phi_psi_indices

    phi_q, psi_q, _ = phi_psi_indices(info.atom_names, info.residue_ids, info.chain_ids)
    x = torch.as_tensor(frames, dtype=torch.float64)
    ang = torch.rad2deg(torch.cat([compute_dihedrals(x, phi_q), compute_dihedrals(x, psi_q)],
                                  1)).numpy()
    edges = np.array([-180.0, -160.0, -150.0, -120.0, -45.0, -20.0, 50.0, 90.0, 180.0])
    return np.abs(ang[..., None] - edges).reshape(len(x), -1).min(1)


def phase_conformations_path(cv: dict, px_min: torch.Tensor) -> dict:
    """Phase 23: the end of config 4 on phase 10's unbiased REMD frames (no
    MD of its own): the structure features over every walker frame, DSSP
    and Baker-Hubbard, SASA of the 3,726-atom assembly, ``EnhancedMSM`` on
    rungs 0-3 and ``find_conformations`` with its representatives. Host
    wall seconds of each step; CUDA events and the peak device memory of the
    features."""
    import tempfile
    from pathlib import Path

    from pmarlo_tpu_torch.conformations import find_conformations
    from pmarlo_tpu_torch.data.chignolin import chignolin_assembly
    from pmarlo_tpu_torch.features import TopologyInfo, featurize_trajectory
    from pmarlo_tpu_torch.features import structure as S
    from pmarlo_tpu_torch.io.pdb import read_pdb
    from pmarlo_tpu_torch.md.topology import build_topology
    from pmarlo_tpu_torch.msm.enhanced import EnhancedMSM

    walls = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return result

    def peak_added(fn):
        """(result, device ms by CUDA events, GiB the call added at its peak)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        result = fn()
        end.record()
        torch.cuda.synchronize()
        return (result, start.elapsed_time(end),
                (torch.cuda.max_memory_allocated() - base) / 2**30)

    t_phase = time.perf_counter()
    res, info, x_min = cv["remd"], cv["info"], cv["x_min"]
    R, N = res.positions.shape[1], res.positions.shape[2]
    radii = S.sasa_radii(info.atom_names)
    out = {"walkers": R, "atoms": N}

    # 1. SASA, H-bonds and phi/psi fractions over every walker's frames
    traj = torch.as_tensor(np.concatenate([res.replica_trajectory(w) for w in range(R)]),
                           dtype=torch.float32, device="cuda")             # (R F, N, 3)
    spec = ["sasa", "hbonds", "ssfrac"]
    (X, meta), out["features_ms"], out["features_peak_gib"] = peak_added(
        lambda: featurize_trajectory(traj, spec, info))
    walls["features_s"] = out["features_ms"] / 1e3
    out["frames"], out["feature_columns"] = int(traj.shape[0]), meta["columns"]
    out["sasa_point_tests"] = float(traj.shape[0]) * N * 96 * N
    _check(X.is_cuda and X.shape == (traj.shape[0], 5), f"features {tuple(X.shape)} on the card")
    _check(bool(torch.isfinite(X).all()), "structure features finite")
    per_atom, out["sasa_per_atom_ms"], _ = peak_added(lambda: S.shrake_rupley_sasa(traj, radii))
    bound = torch.as_tensor(4.0 * np.pi * (radii + 0.14) ** 2, dtype=torch.float32,
                            device="cuda")
    _check(bool(((per_atom >= 0) & (per_atom <= bound * (1 + 1e-6))).all()),
           "per-atom SASA in [0, 4 pi (r + 0.14)^2]")
    _check(torch.equal(per_atom.sum(1), X[:, 0]), "the sasa column is the per-atom sum")
    sel = np.linspace(0, traj.shape[0] - 1, CONFORMATION_CHECK_FRAMES).astype(int)
    frames = traj[sel].cpu().numpy()
    X_cpu, _ = featurize_trajectory(frames, spec, info, device="cpu")
    out["check_sasa"] = _sasa_agreement(
        "walker frames", per_atom[sel].cpu().numpy(),
        S.shrake_rupley_sasa(frames, radii, device="cpu").numpy(), frames, radii)
    Xc, Xh = X[sel].cpu().numpy(), X_cpu.numpy()
    elements = [S._element_of(n) for n in info.atom_names]
    donors, acceptors = S.find_donors_acceptors(info.atom_names, elements, info.bonds)
    hb_off = np.flatnonzero(Xc[:, 1] != Xh[:, 1])
    ss_off = np.flatnonzero((Xc[:, 2:] != Xh[:, 2:]).any(1))
    _check(bool((_hbond_margins(frames[hb_off], donors, acceptors) <= HBOND_THRESHOLD).all()),
           f"H-bond counts differ off a cutoff in frames {hb_off.tolist()}")
    _check(bool((_ss_margins(frames[ss_off], info) <= SS_THRESHOLD_DEG).all()),
           f"ss fractions differ off a boundary in frames {ss_off.tolist()}")
    out.update(check_hbond_frames_at_threshold=len(hb_off),
               check_ssfrac_frames_at_threshold=len(ss_off))
    out["sasa_total_nm2_mean"] = float(X[:, 0].mean())
    out["hbonds_mean"] = float(X[:, 1].mean())
    out["ssfrac_alpha_beta_coil_mean"] = X[:, 2:].mean(0).tolist()

    # 2. DSSP and Baker-Hubbard over the same frames on the card
    codes = timed("dssp_s", lambda: S.dssp(traj, info))
    _check(codes.is_cuda and codes.dtype == torch.int8, "DSSP codes on the card")
    e, allowed, _ = S.kabsch_sander_energies(traj[sel], info)
    hb = (e < -0.5) & allowed[None]
    e_cpu, allowed_cpu, _ = S.kabsch_sander_energies(frames, info, device="cpu")
    hb_cpu = (e_cpu < -0.5) & allowed_cpu[None]
    flips = (hb.cpu() != hb_cpu)
    near = (e_cpu + 0.5).abs() <= KS_THRESHOLD_KCAL
    _check(not bool(flips[~near].any()), "K&S H-bonds differ off the -0.5 cutoff")
    same = ~flips.any(dim=(1, 2))
    codes_cpu = S.dssp(frames, info, device="cpu")
    _check(torch.equal(codes[sel].cpu()[same], codes_cpu[same]),
           "DSSP codes of the card and the CPU")
    out["check_ks_pairs_at_threshold"] = int(flips.sum())
    out["ks_energy_max_abs_err_kcal"] = float((e.cpu() - e_cpu).abs().max())
    native = S.ss_fractions_dssp(x_min, info)[0].tolist()
    run = torch.stack([(codes == k).float().mean() for k in (1, 2, 0)]).tolist()
    out["dssp_native_helix_strand_coil"] = native
    out["dssp_run_helix_strand_coil"] = run
    out["dssp_native"] = "".join(DSSP_LETTERS[S.dssp(x_min, info)[0].cpu().numpy()])
    triplets = timed("baker_hubbard_s", lambda: S.baker_hubbard(traj, info, freq=0.1))
    _check(triplets.dtype == np.int64 and triplets.ndim == 2, "Baker-Hubbard triplets")
    out["baker_hubbard_freq_0_1"] = [
        f"{info.residue_names[d]}{info.residue_ids[d]}:{info.atom_names[h]}->"
        f"{info.residue_names[a]}{info.residue_ids[a]}:{info.atom_names[a]}"
        for d, h, a in triplets.tolist()]

    # 3. SASA of the 3,726-atom assembly on the card, chunked, and on the CPU
    ainfo = TopologyInfo.from_topology(build_topology(chignolin_assembly(PROTEIN_COPIES)))
    aradii = S.sasa_radii(ainfo.atom_names)
    xa = px_min.detach().to(torch.float32)[None]
    assembly, out["assembly_sasa_ms"], out["assembly_sasa_peak_gib"] = peak_added(
        lambda: S.shrake_rupley_sasa(xa, aradii))
    t0 = time.perf_counter()
    assembly_cpu = S.shrake_rupley_sasa(xa.cpu(), aradii)
    out["assembly_sasa_cpu_s"] = time.perf_counter() - t0
    xa_np = xa[0].cpu().numpy()
    out["assembly_atoms"] = int(xa.shape[1])
    out["check_assembly_sasa"] = _sasa_agreement(
        "assembly", assembly.cpu().numpy(), assembly_cpu.numpy(), xa_np[None], aradii)
    alone = torch.cat([S.shrake_rupley_sasa(xa[:, k * N:(k + 1) * N], aradii[k * N:(k + 1) * N])
                       for k in range(xa.shape[1] // N)], dim=1)
    _check(bool((assembly <= alone).all()), "an atom's SASA grew beside the other copies")
    out["assembly_atoms_buried_by_other_copies"] = int((assembly < alone).sum())
    out["assembly_sasa_nm2"] = float(assembly.sum())

    # 4. EnhancedMSM on rungs 0-3, into a temporary directory
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    trajs = [res.demuxed_trajectory(r) for r in range(4)]
    m = EnhancedMSM(topology=info, temperature_K=300.0, output_dir=root / "msm")
    _check(m.device.type == "cuda", f"EnhancedMSM resolved {m.device}")
    timed("load_s", lambda: m.load_trajectories(trajs))
    allocated = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
    timed("compute_features_s", lambda: m.compute_features(
        "phi_psi", use_tica=True, tica_lag=ANALYSIS_LAG, tica_components=2))
    grew = torch.cuda.memory_stats()["allocated_bytes.all.allocated"] - allocated
    _check(grew >= sum(t.nbytes for t in trajs), f"features computed on the card ({grew} B)")
    _check(all(f.dtype == np.float32 and f.shape == (len(trajs[0]), 2) for f in m.features),
           "TICA features on the host, float32")
    out["enhanced_tica_eigenvalues"] = m.feature_info["tica"]["eigenvalues"]
    timed("cluster_s", lambda: m.cluster_features(ANALYSIS_STATES, seed=0))
    timed("build_msm_s", lambda: m.build_msm(ANALYSIS_LAG))
    its = timed("its_s", lambda: m.compute_implied_timescales(n_samples=100))
    _its_gates("enhanced", its)
    ck = timed("ck_macro_s", lambda: m.compute_ck_test(macro=2))
    fes = timed("fes_s", lambda: m.generate_free_energy_surface(0, 1, bins=24))
    table = timed("state_table_s", lambda: m.create_state_table(free_energy_errors=True))
    pdbs = timed("representatives_s", m.extract_representative_structures)
    saved = timed("save_s", m.save_analysis_results)
    msm = m.msm
    active = msm.active_states
    T, pi = msm.transition_matrix, msm.stationary_distribution
    Ta, pia = msm.restricted_T(), pi[active]
    _check(float(np.abs(Ta.sum(1) - 1.0).max()) <= 1e-10, "T's rows sum to 1")
    _check(float(np.abs(pia @ Ta - pia).max()) <= 1e-10 and
           float(np.abs(pi @ T - pi).max()) <= 1e-10, "pi T = pi")
    _check(bool(np.isfinite(fes.free_energy).any()), "EnhancedMSM FES has finite bins")
    rows = [r for r in table if r["active"]]
    _check([r["state"] for r in rows] == active.tolist() and len(pdbs) == len(active),
           "one state-table row and one representative PDB per active state")
    pdb_err = 0.0
    for row, path in zip(rows, pdbs):
        rep = row["representative"]
        pdb_err = max(pdb_err, float(np.abs(read_pdb(path).coordinates()
                                            - trajs[rep["traj"]][rep["frame"]]).max()))
    _check(pdb_err <= 1e-3, f"state PDBs read back {pdb_err} nm off their frames")
    _check((saved / "msm_result.pkl").exists() and (saved / "state_table.json").exists(),
           "analysis results saved")
    out.update({
        "enhanced_active_states": int(len(active)), "enhanced_lag": int(msm.lag),
        "enhanced_its_slowest_frames": its.timescales[:, 0].tolist(),
        "enhanced_ck_macro_rms": {int(k): v for k, v in ck.rms.items()},
        "enhanced_fes_finite_share": float(fes.finite_fraction),
        "enhanced_state_pdb_max_err_nm": pdb_err,
        "enhanced_free_energy_err_kJ": [r.get("free_energy_err") for r in rows],
    })

    # 5. find_conformations on the active block, representatives from rungs 0-3
    Tn = Ta / Ta.sum(1, keepdims=True)
    remap = np.full(msm.n_states, -1, np.int64)
    remap[active] = np.arange(len(active))
    mapped = [remap[d] for d in m.dtrajs]
    conf_dir = root / "conformations"
    cs = timed("find_conformations_s", lambda: find_conformations(
        Tn, n_macrostates=2, committor_tolerance=0.2,
        features=np.concatenate(m.features), dtraj=np.concatenate(mapped),
        traj_lengths=[len(t) for t in trajs], trajectories=trajs, topology=info,
        output_dir=conf_dir, bootstrap=True, dtrajs_for_bootstrap=mapped,
        lag_for_bootstrap=ANALYSIS_LAG))
    tpt = cs.tpt
    qp, qm = tpt.forward_committor, tpt.backward_committor
    A, B = tpt.source_states, tpt.sink_states
    _check(bool(((qp >= 0) & (qp <= 1)).all() and (qp[A] == 0).all() and (qp[B] == 1).all()),
           "q+ in [0, 1], 0 on the source, 1 on the sink")
    out["committor_sum_off_1"] = float(np.abs(qp + qm - 1.0).max())
    _check(out["committor_sum_off_1"] <= 1e-10, "q+ + q- = 1 (reversible MSM)")
    middle = np.setdiff1d(np.arange(len(Tn)), np.concatenate([A, B]))
    conservation = np.abs(tpt.net_flux.sum(1) - tpt.net_flux.sum(0))[middle]
    out["net_flux_conservation_max"] = float(conservation.max()) if len(middle) else 0.0
    _check(out["net_flux_conservation_max"] <= 1e-10, "net flux conserved at intermediates")
    _check(len(cs.conformations) >= 1, "at least one conformation")
    _check(bool(np.isfinite(cs.kis.scores).all()), "KIS scores finite")
    reps = []
    for c in cs.conformations:
        _check(c.pdb_path is not None and Path(c.pdb_path).exists(),
               f"state {c.state}: representative PDB written")
        rep = c.representative
        x = torch.as_tensor(trajs[rep["traj"]][rep["frame"]], device="cuda")
        reps.append({
            "state": c.state, "kind": c.kind, "macrostate": c.macrostate,
            "committor": c.committor, "population": c.population, "kis": c.kis_score,
            "sasa_nm2": float(S.shrake_rupley_sasa(x, radii).sum()),
            "hbonds": float(S.hydrogen_bonds(x, donors, acceptors)[0]),
            "dssp": "".join(DSSP_LETTERS[S.dssp(x, info)[0].cpu().numpy()]),
        })
    out.update({
        "conformations": reps,
        "source": A.tolist(), "sink": B.tolist(),
        "tpt_rate_per_frame": float(tpt.rate), "tpt_mfpt_frames": float(tpt.mfpt),
        "bootstrap": cs.uncertainty.to_dict() if cs.uncertainty is not None else None,
    })
    tmp.cleanup()
    walls["phase_s"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    _line("phase 23 conformations path", out)
    return out


def _pair_rows_vs_plain(fn, x: torch.Tensor) -> dict:
    """Rows 3-5 (the dense Born, energy and force sweeps) against their plain
    versions at positions ``x (R, N, 3)``, and the whole evaluation, under
    phase 6's gates (I, e_rows, dE/dB and the total energy within 1e-5 of
    max, the forces within 1e-4)."""
    Ip, Ik = fn.born_reference(x), fn.born(x)
    B, dB = fn.born_radii(Ip)
    ep, dp = fn.energy_rows_reference(x, B)
    ek, dk = fn.energy_rows(x, B)
    _, c = fn.gb_terms(B, dB, dp)
    Fp, Fk = fn.pair_forces_reference(x, B, c), fn.pair_forces(x, B, c)
    Ek, Gk = fn(x)
    Ep, Gp = fn.reference(x)
    torch.cuda.synchronize()
    out = {
        "born_max_abs_err": float((Ik - Ip).abs().max()), "born_rel_err": _rel(Ik, Ip),
        "e_rows_rel_err": _rel(ek, ep), "dEdB_max_abs_err": float((dk - dp).abs().max()),
        "dEdB_rel_err": _rel(dk, dp), "force_max_abs_err": float((Fk - Fp).abs().max()),
        "force_rel_err": _rel(Fk, Fp), "total_energy_rel_err": _rel(Ek, Ep),
        "total_force_rel_err": _rel(Gk, Gp), "energy_kJ_mol": float(Ek.double().mean()),
        "max_force": float(Gk.abs().max()),
    }
    for key in ("born_rel_err", "e_rows_rel_err", "dEdB_rel_err", "total_energy_rel_err"):
        _check(out[key] <= 1e-5, f"{key} {out[key]}")
    for key in ("force_rel_err", "total_force_rel_err"):
        _check(out[key] <= 1e-4, f"{key} {out[key]}")
    _check(bool(torch.isfinite(Gk).all()), "pair forces finite")
    return out


def _cli(argv) -> dict:
    """``pmarlo_tpu_torch.main.main(argv)`` in this process: its exit code
    0, and the JSON object it prints (its standard output echoed)."""
    import contextlib
    import io

    from pmarlo_tpu_torch.main import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    text = buf.getvalue()
    print(text.strip(), flush=True)
    _check(rc == 0, f"pmarlo-tpu-torch {argv[0]} exited {rc}")
    start = text.index("{")
    return json.loads(text[start:])


def _rebuilt_bonds(raw, topology) -> dict:
    """Largest deviation from the force field's r0 (relative) of the bonds
    preparation rebuilt (one atom absent from ``raw``): the ring closures
    (TRP CZ2-CH2, the CD2-CE2 of TRP and TYR) and every other bond."""
    from pmarlo_tpu_torch.md.ff_params import lookup_bond

    present = {(a.chain, a.resid, a.name) for r in raw.residues for a in r.atoms}
    x = topology.positions
    keys = [(c, int(r), str(n)) for c, r, n in zip(
        topology.chain_ids, topology.residue_ids, topology.atom_names)]
    worst = {"ring_closure": 0.0, "other": 0.0, "bonds": 0}
    for i, j in np.asarray(topology.bonds):
        if keys[i] in present and keys[j] in present:
            continue
        d = float(np.linalg.norm(x[i] - x[j])) * 10.0
        r0 = lookup_bond(topology.atom_types[i], topology.atom_types[j])[1]
        kind = ("ring_closure" if {keys[i][2], keys[j][2]} in RING_CLOSURES else "other")
        worst[kind] = max(worst[kind], abs(d - r0) / r0)
        worst["bonds"] += 1
    return worst


# one evaluation of the pair path at R=8 under ``profiling.trace``, in a fresh
# process: in the whole script (after phases 1-23) this process's trace held
# no kernel event, though alone, and after other profiler sessions and CUDA
# graphs in a short process, it held them all (H100 runs, PERF.md)
_TRACE_CHILD = """
import sys, torch
import pmarlo_tpu_torch
from pmarlo_tpu_torch.md.forcefield import build_system
from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn
from pmarlo_tpu_torch.utils.profiling import trace
system, x = build_system(sys.argv[1], gb_model="gbn2", dense_scales=False, device="cuda")
fn = build_pair_force_fn(system)
xs = x[None].repeat(8, 1, 1).contiguous()
fn(xs)
torch.cuda.synchronize()
with trace(sys.argv[2]):
    fn(xs)
"""


def _traced_pair_kernels(pdb, log_dir) -> dict:
    """Which of rows 3-5 the Chrome trace of one pair evaluation names."""
    from pathlib import Path

    root = Path(__file__).resolve().parent
    subprocess.run([sys.executable, "-c", _TRACE_CHILD, str(pdb), str(log_dir)],
                   cwd=root, check=True, timeout=600)
    events = json.loads((Path(log_dir) / "trace.json").read_text())["traceEvents"]
    names = {str(ev.get("name", "")) for ev in events if ev.get("cat") == "kernel"}
    return {k: any(f"{k}_kernel" in n for n in names) for k in PAIR_KERNELS}


def phase_structure_prep():
    """Phase 24: a raw, stripped 3,726-atom assembly -> ``Protein.prepare``
    (with ``add_missing_residues`` on the gapped chain and ``prepare``
    again) -> ``create_system`` on the card -> rows 3-5 against their plain
    versions and one evaluation under ``profiling.trace`` (in a child
    process) -> the CLI
    (``info``, ``remd``, ``run-segment``) on the prepared PDB; the three as
    stages of a ``workflow.Pipeline`` with a checkpoint, run twice (the
    second replays every stage). Returns the phase's numbers and the first
    chain of the prepared structure, which phase 25 takes."""
    import tempfile
    from pathlib import Path

    from pmarlo_tpu_torch.data.chignolin import chignolin_assembly, raw_chignolin_assembly
    from pmarlo_tpu_torch.md.minimize import minimize_energy
    from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn
    from pmarlo_tpu_torch.md.topology import build_topology
    from pmarlo_tpu_torch.protein import Protein
    from pmarlo_tpu_torch.utils.profiling import StageTimer, device_memory_stats
    from pmarlo_tpu_torch.workflow import Pipeline, RunStatus

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    work = Path(tmp.name)
    timer = StageTimer()
    calls = {"prepare": 0, "system": 0, "cli": 0}
    live = {}
    raw, gap = raw_chignolin_assembly(PROTEIN_COPIES)
    ref = build_topology(chignolin_assembly(PROTEIN_COPIES))

    def prepare(ctx):
        calls["prepare"] += 1
        with timer.stage("prepare"):
            p = Protein(raw, ph=7.0).prepare()
            found = p.find_missing_residues()
            closures = p.add_missing_residues(sequences=gap, tol_nm=PREP_TOL_NM)
            p.prepare()
        top = p.topology
        _check(set(found) == set(gap), f"gaps found {found}, made {gap}")
        _check(list(top.atom_names) == list(ref.atom_names)
               and list(top.residue_names) == list(ref.residue_names)
               and list(top.chain_ids) == list(ref.chain_ids),
               "prepared residues, names and order differ from the assembly's")
        charge = int(round(float(top.charges.sum())))
        _check(charge == int(round(float(ref.charges.sum()))), f"formal charge {charge}")
        got = {(a.chain, a.resid, a.name): a.xyz for r in p.structure.residues for a in r.atoms}
        kept = [a for r in raw.residues for a in r.atoms if a.name not in PHOSPHATE]
        _check(all(got[(a.chain, a.resid, a.name)] == a.xyz for a in kept),
               "a raw heavy atom moved")
        bonds = _rebuilt_bonds(raw, top)
        _check(bonds["ring_closure"] <= PREP_RING_BOND_REL and bonds["other"] <= PREP_BOND_REL,
               f"rebuilt bonds off r0: {bonds}")
        closure = max(closures.values())
        _check(closure < 3 * PREP_TOL_NM, f"closure RMSD {closure} nm")
        live["protein"] = p
        props = {k: v for k, v in p.get_properties().items() if k != "sequence"}
        return {"prepared_pdb": str(p.save_prepared(work / "prepared.pdb")),
                "raw_atoms": raw.n_atoms, "atoms": top.n_atoms,
                "raw_heavy_atoms_kept_bitwise": len(kept), "rebuilt_bonds": bonds,
                "closure_rmsd_nm": closure, "properties": props}

    def system(ctx):
        calls["system"] += 1
        p = live["protein"]
        with timer.stage("create_system") as box:
            sysc, x0 = p.create_system(hydrogen_mass=3.0)
            box["x0"] = x0
        _check(sysc.device.type == "cuda" and x0.device.type == "cuda"
               and sysc.masses.device.type == "cuda", "create_system() is not on the card")
        fn = build_pair_force_fn(sysc)
        rng = np.random.default_rng(24)
        out = {}
        with timer.stage("rows_vs_plain"):
            noise = torch.as_tensor(rng.normal(0.0, 0.005, (PROTEIN_REPLICAS, sysc.n_atoms, 3)),
                                    dtype=torch.float32, device="cuda")
            out["prepared"] = _pair_rows_vs_plain(fn, x0[None] + noise)
            x_min, _ = minimize_energy(sysc, x0, force_fn=fn)
            out["minimized"] = _pair_rows_vs_plain(fn, x_min[None] + noise)
        traced = _traced_pair_kernels(p.save_prepared(work / "traced.pdb"), work / "trace")
        _check(all(traced.values()), f"the trace lacks a pair kernel: {traced}")
        mem = device_memory_stats()
        _check(bool(mem) and mem["cuda:0"]["bytes_limit"] > 0, f"device memory {mem}")
        return {"system_device": str(x0.device), "rows": out, "traced_kernels": traced,
                "device_memory": mem}

    def console(ctx):
        calls["cli"] += 1
        info = _cli(["info"])
        _check(info["backend"] == "cuda" and torch.cuda.get_device_name(0) in info["devices"],
               f"info {info}")
        pdb = ctx["prepared_pdb"]
        torch.cuda.synchronize()
        _reset_counts()
        with timer.stage("cli_remd", n_items=CLI_STEPS):
            t0 = time.perf_counter()
            remd = _cli(["remd", pdb, "--replicas", str(PROTEIN_REPLICAS), "--steps",
                         str(CLI_STEPS), "--dt", "0.004", "--constraints", "hbonds", "--tmin",
                         "300", "--tmax", "330"])
            wall = time.perf_counter() - t0
        counts = _counts()
        # FIRE's 500 iterations and its final energy, one an MD step, one a
        # frame (RemdConfig's report interval, 100)
        evals = 501 + CLI_STEPS + CLI_STEPS // 100
        _check(all(counts[k] == evals for k in PAIR_KERNELS),
               f"pair launches {counts} for {evals} force evaluations")
        _check(counts["fused_md_chunk"] == 0, "the CLI's protein REMD launched the fused chunk")
        _check(remd["frames"] == [CLI_STEPS // 100, PROTEIN_REPLICAS, ctx["atoms"], 3],
               f"frames {remd['frames']}")
        _check(0.0 < remd["mean_acceptance"] < 1.0, f"acceptance {remd['mean_acceptance']}")
        _reset_counts()
        with timer.stage("cli_run_segment", n_items=CLI_SEGMENT_STEPS):
            seg = _cli(["run-segment", pdb, "--steps", str(CLI_SEGMENT_STEPS),
                        "--report-interval", "100", "--output", str(work / "segment.npz")])
        seg_counts = _counts()
        _check(np.isfinite(seg["final_temperature_K"]), f"run-segment {seg}")
        _check(len({seg_counts[k] for k in PAIR_KERNELS}) == 1
               and seg_counts["pair_force"] >= CLI_SEGMENT_STEPS,
               f"run-segment pair launches {seg_counts}")
        sim_ns = CLI_STEPS * 0.004 * 1e-3 * PROTEIN_REPLICAS
        return {"info": info, "remd": remd, "remd_wall_s": wall,
                "remd_launches": {k: counts[k] for k in PAIR_KERNELS},
                "remd_force_evaluations": evals,
                "remd_ms_per_step_with_setup": wall / CLI_STEPS * 1e3,
                "remd_ns_per_day_with_setup": sim_ns * 86_400.0 / wall,
                "segment": seg, "segment_launches": {k: seg_counts[k] for k in PAIR_KERNELS}}

    def pipeline():
        return (Pipeline("structure_prep", checkpoint=work / "pipeline.json")
                .add("prepare", prepare).add("system", system).add("cli", console))

    first = pipeline().run({})
    again = pipeline()
    second = again.run({})
    _check(all(r.status == RunStatus.SKIPPED for r in again.results),
           f"the re-run did not replay: {[r.status for r in again.results]}")
    _check(calls == {"prepare": 1, "system": 1, "cli": 1}, f"stage calls {calls}")
    strip = ("__pipeline_results__",)
    _check({k: v for k, v in first.items() if k not in strip}
           == {k: v for k, v in second.items() if k not in strip},
           "the replayed context differs")
    out = {k: v for k, v in first.items() if k not in strip + ("prepared_pdb",)}
    out["launches"] = {k: out["remd_launches"][k] + out["segment_launches"][k]
                       for k in PAIR_KERNELS}
    out["stage_timer"] = timer.summary()
    out["pipeline_replayed"] = [r.status.value for r in again.results]
    out["phase_s"] = time.perf_counter() - t_phase
    tmp.cleanup()
    _line("phase 24 structure prep", out)
    print(f"stage timer: {json.dumps(timer.summary())}", flush=True)
    chain_a = [r for r in live["protein"].structure.residues if r.chain == "A"]
    return out, chain_a


def phase_nucleic_complex(chain) -> dict:
    """Phase 25: the first chain of phase 24's prepared assembly beside a
    DNA (GATC) and an RNA (GACU) strand -> ``add_hydrogens`` ->
    ``build_system(gb_model="gbn2")`` on the card -> FIRE ->
    ``ReplicaExchange(use_kernel=True)`` at R=8: the fused chunk (row 1)
    against its plain version over one 100-step chunk (phase 2's gate), then
    4 ps of equilibration and 2,000 steps at 1 fs."""
    from pmarlo_tpu_torch.data.chignolin import shifted_residues
    from pmarlo_tpu_torch.data.dna import dna_single_strand, rna_single_strand
    from pmarlo_tpu_torch.io.pdb import PDBStructure
    from pmarlo_tpu_torch.md import analytic
    from pmarlo_tpu_torch.md.forcefield import build_system
    from pmarlo_tpu_torch.md.fused_md import MAX_ATOMS
    from pmarlo_tpu_torch.md.integrate import make_force_fn
    from pmarlo_tpu_torch.md.minimize import minimize_energy
    from pmarlo_tpu_torch.protein.hydrogens import add_hydrogens
    from pmarlo_tpu_torch.remd.remd import RemdConfig, ReplicaExchange

    t_phase = time.perf_counter()
    protein, _ = build_system(PDBStructure(residues=list(chain)), gb_model="gbn2")
    q_protein = float(protein.charges.double().sum())
    out = {"protein_atoms": protein.n_atoms, "protein_charge": q_protein, "launches": 0}
    for kind, strand in (("dna", dna_single_strand("GATC", chain="X")),
                         ("rna", rna_single_strand("GACU", chain="X"))):
        t0 = time.perf_counter()
        combo = add_hydrogens(
            PDBStructure(residues=list(chain) + shifted_residues(strand.residues)), ph=7.0)
        system, x0 = build_system(combo, gb_model="gbn2")
        _check(system.device.type == "cuda", f"{kind}: build_system is not on the card")
        _check(system.n_atoms <= MAX_ATOMS, f"{kind}: {system.n_atoms} atoms")
        dq = float(system.charges.double().sum()) - q_protein
        _check(abs(dq + 3.0) <= 1e-4, f"{kind}: strand charge {dq}")
        x_min, e_min = minimize_energy(system, x0, max_iterations=NUCLEIC_FIRE,
                                       force_fn=make_force_fn(system))
        _check(bool(torch.isfinite(e_min)), f"{kind}: FIRE energy {e_min}")
        cfg = RemdConfig(n_replicas=NUCLEIC_REPLICAS, t_min=300.0, t_max=330.0,
                         exchange_frequency=100, report_interval=50,
                         equilibration_steps=NUCLEIC_EQUILIBRATION,
                         dt_ps=NUCLEIC_DT_PS, seed=25)
        remd = ReplicaExchange(system, x_min, cfg, use_kernel=True, minimize=False)
        # phase 2's protocol: the minimum with 0.005 nm of noise a replica (at
        # the minimum itself the forces are a residual of cancelling terms)
        chunk, st = remd._chunk, remd.state
        rng = np.random.default_rng(25)
        x = st.positions + torch.as_tensor(rng.normal(0.0, 0.005, tuple(st.positions.shape)),
                                           dtype=torch.float32, device="cuda")
        args = (x, st.velocities, st.seeds, remd.ladder, 100, 0)
        ek0, fk0 = chunk.energy_and_forces(x)
        ep0, fp0 = analytic.energy_and_forces(chunk.dense, x)
        xk, vk, ek = chunk(*args)
        xp, vp, ep = chunk.reference(*args)
        e_at_xk, _ = analytic.energy_and_forces(chunk.dense, xk)
        torch.cuda.synchronize()
        r = {"atoms": system.n_atoms, "strand_charge": dq, "fire_energy_kJ_mol": float(e_min),
             "force_max_abs_err": float((fk0 - fp0).abs().max()),
             "force_rel_err": _rel(fk0, fp0), "energy_rel_err": _rel(ek0, ep0),
             "chunk_max_dx_nm": float((xk - xp).abs().max()),
             "chunk_energy_rel_err": _rel(ek, e_at_xk),
             "chunk_traj_energy_rel_diff": _rel(ek, ep)}
        _check(r["force_rel_err"] <= 1e-4 and r["energy_rel_err"] <= 1e-4,
               f"{kind}: kernel vs plain {r}")
        _check(bool(torch.isfinite(xk).all()) and r["chunk_max_dx_nm"] <= 1e-3
               and r["chunk_energy_rel_err"] <= 1e-4, f"{kind}: 100-step chunk {r}")
        torch.cuda.synchronize()
        _reset_counts()
        res = remd.run(NUCLEIC_STEPS)
        counts = _counts()
        # one launch for the equilibration, then one a frame
        launches = 1 + NUCLEIC_STEPS // cfg.report_interval
        _check(counts["fused_md_chunk"] == launches,
               f"{kind}: {counts['fused_md_chunk']} chunk launches, not {launches}")
        per_rung = (res.kinetic_temperature / res.temperatures[None, :]).mean(0)
        r.update({"launches": counts["fused_md_chunk"], "run_wall_s": res.wall_seconds,
                  "mean_acceptance": res.mean_acceptance,
                  "kinetic_over_target": float(per_rung.mean()),
                  "kinetic_over_target_per_rung": [float(v) for v in per_rung],
                  "phase_part_s": time.perf_counter() - t0})
        _check(bool(np.isfinite(res.positions).all()), f"{kind}: frames finite")
        _check(NUCLEIC_T_MEAN_BAND[0] <= r["kinetic_over_target"] <= NUCLEIC_T_MEAN_BAND[1]
               and all(NUCLEIC_T_BAND[0] <= v <= NUCLEIC_T_BAND[1] for v in per_rung),
               f"{kind}: kinetic/target {per_rung}")
        _check(0.0 < res.mean_acceptance < 1.0, f"{kind}: acceptance {res.mean_acceptance}")
        out[kind] = r
        out["launches"] += counts["fused_md_chunk"]
    out["phase_s"] = time.perf_counter() - t_phase
    _line("phase 25 nucleic complex", out)
    return out


# phase 26: the API facade and the reports from a restart of phase 10's last
# 300 K frame. The restart runs phase 10's configuration through row 1 for
# API_RESTART_STEPS (nothing cut: 200 launches of 50 steps); the API then
# works on its rungs 0-3 (4 x 200 frames), at phase 23's 16 states and lag 2
API_RESTART_STEPS = 10_000
API_RUNGS = 4
API_STATES = 16
API_LAG = 2
API_ALIGN_FRAMES = 64             # frames of the alignment check
API_ALIGN_TOL_NM = 1e-5
PDB_ROUNDING_NM = 5.1e-5          # half the PDB's 1e-4 nm (1e-3 A) resolution,
                                  # and float32 rounding of coordinates of a few nm
DASHBOARD_CARDS = ("Run summary", "Free-energy surface", "Implied timescales",
                   "Chapman-Kolmogorov", "MSM", "State table")


def _system_differences(a, b) -> list:
    """The fields of two Systems that differ (tensors compared bit for bit
    on the host)."""
    diff = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            same = (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
                    and x.shape == y.shape and x.dtype == y.dtype
                    and torch.equal(x.cpu(), y.cpu()))
        else:
            same = x == y
        if not same:
            diff.append(f.name)
    return diff


def _dashboard_titles(page: str) -> list:
    return re.findall(r"<h2>(.*?)</h2>", page)


def phase_api_reports(cv: dict, cx: dict) -> dict:
    """Phase 26: ``api.extract_last_frame_to_pdb`` writes phase 10's last
    300 K frame; ``run_replica_exchange(pdb, use_kernel=True)`` restarts
    from it at phase 10's ladder (R=32, 300-450 K, 2 fs, an exchange every
    100 steps) through row 1, held against its plain version over one
    100-step chunk at the restart positions (phase 2's gates), its System
    against phase 10's field by field; then the API on rungs 0-3 on the
    card (features and their cache, alignment, the universal embedding,
    k-means, the MSM, macrostates, FES minima, conformations and their
    writers, the sampling benchmark); ``api.analyze_msm`` into a run
    directory with its plots; the plots of the run and the interactive
    pages; the dashboard exported, through the CLI and served once. Host
    wall seconds of each step, CUDA events around the restart. Where the
    host has no matplotlib, the steps that render are listed and not run."""
    import importlib.util
    import socket
    import tempfile
    import threading
    import urllib.error
    import urllib.request
    from pathlib import Path

    from pmarlo_tpu_torch import api, benchmark
    from pmarlo_tpu_torch.features import featurize_trajectory
    from pmarlo_tpu_torch.io.pdb import read_pdb
    from pmarlo_tpu_torch.md import analytic
    from pmarlo_tpu_torch.md.forces import potential_energy
    from pmarlo_tpu_torch.md.fused_md import build_fused_chunk
    from pmarlo_tpu_torch.remd.remd import run_replica_exchange

    walls = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return result

    t_phase = time.perf_counter()
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    out = {"matplotlib": have_mpl}
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    info, system10, res10 = cv["info"], cx["system"], cv["remd"]
    R, cfg = N_REPLICAS, _remd_config(seed=26)

    # 1. the restart: the last 300 K frame to a PDB, the System rebuilt from it
    pdb = timed("extract_pdb_s", lambda: api.extract_last_frame_to_pdb(
        res10.positions[:, 0], info, root / "restart.pdb"))
    x_file = read_pdb(pdb).coordinates()
    out["pdb_rounding_max_nm"] = float(np.abs(x_file - res10.positions[-1, 0]).max())
    _check(out["pdb_rounding_max_nm"] <= PDB_ROUNDING_NM,
           f"the PDB holds the frame within {out['pdb_rounding_max_nm']} nm")
    xf = torch.as_tensor(x_file, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    _reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res, system = run_replica_exchange(pdb, n_steps=API_RESTART_STEPS, config=cfg,
                                       use_kernel=True)
    end.record()
    torch.cuda.synchronize()
    walls["restart_s"] = time.perf_counter() - t0
    walls["restart_events_s"] = start.elapsed_time(end) / 1e3
    walls["restart_run_s"] = res.wall_seconds
    counts = _counts()
    out["launches"] = counts["fused_md_chunk"]
    _check(out["launches"] == API_RESTART_STEPS // cfg.report_interval,
           f"{out['launches']} chunk launches in the restart")
    _check(all(v == 0 for k, v in counts.items() if k != "fused_md_chunk"),
           f"only row 1 on the restart's path: {counts}")
    _check(system.device.type == "cuda", "the rebuilt System lies on the card")
    out["system_fields_differing"] = _system_differences(system, system10)
    _check(not out["system_fields_differing"],
           f"the System rebuilt from the PDB differs in {out['system_fields_differing']}")
    e10, e_file = potential_energy(system10, xf), potential_energy(system, xf)
    out["energy_at_file_positions_kJ_mol"] = float(e_file)
    _check(torch.equal(e10, e_file), f"energy at the file's positions {e10} vs {e_file}")
    out["mean_acceptance"] = res.mean_acceptance
    out["kinetic_over_target"] = _kinetic_ratio(res, cfg)
    _check(0.0 < res.mean_acceptance < 1.0, f"restart acceptance {res.mean_acceptance}")
    _check(0.97 <= out["kinetic_over_target"] <= 1.03,
           f"restart kinetic/target {out['kinetic_over_target']}")
    _check(bool(np.isfinite(res.positions).all()), "restart frames finite")

    # row 1 against its plain version at the restart positions (phase 2's
    # gates); launched after the run's counts were read, so not counted
    chunk = build_fused_chunk(system, dt=DT_PS, friction=cfg.friction_per_ps, n_replicas=R)
    rng = np.random.default_rng(26)
    temps = _ladder()
    x = xf[None].expand(R, -1, -1).contiguous()
    v = _mb_velocities(system, temps, rng)
    seeds = torch.as_tensor(rng.integers(0, 2**31 - 1, R), dtype=torch.int32, device="cuda")
    ek0, fk0 = chunk.energy_and_forces(x)
    ep0, fp0 = analytic.energy_and_forces(chunk.dense, x)
    xk, _, ek = chunk(x, v, seeds, temps, 100, 0)
    xp, _, _ = chunk.reference(x, v, seeds, temps, 100, 0)
    e_at_xk, _ = analytic.energy_and_forces(chunk.dense, xk)
    torch.cuda.synchronize()
    row1 = {"force_max_abs_err": float((fk0 - fp0).abs().max()),
            "force_rel_err": _rel(fk0, fp0), "energy_rel_err": _rel(ek0, ep0),
            "chunk_max_dx_nm": float((xk - xp).abs().max()),
            "chunk_energy_rel_err": _rel(ek, e_at_xk)}
    out["row1_vs_plain"] = row1
    _check(row1["force_rel_err"] <= 1e-4 and row1["energy_rel_err"] <= 1e-4,
           f"row 1 vs plain at the restart positions {row1}")
    _check(bool(torch.isfinite(xk).all()) and row1["chunk_max_dx_nm"] <= 1e-3
           and row1["chunk_energy_rel_err"] <= 1e-4, f"row 1's 100-step chunk {row1}")

    # 2. the API on rungs 0-3, on the card; every result a host array
    trajs = [np.ascontiguousarray(res.positions[:, r]) for r in range(API_RUNGS)]
    F = trajs[0].shape[0]
    traj = np.concatenate(trajs)
    api.clear_feature_cache()
    X, meta = timed("features_s", lambda: api.compute_features(
        traj, "phi_psi", info, cos_sin_expand=True))
    X2, _ = timed("features_cached_s", lambda: api.compute_features(
        traj, "phi_psi", info, cos_sin_expand=True))
    Xd, _ = featurize_trajectory(traj, "phi_psi", info, cos_sin_expand=True)
    _check(isinstance(X, np.ndarray) and X2 is X, "compute_features: host array, cached")
    _check(Xd.is_cuda and np.array_equal(Xd.cpu().numpy(), X),
           "compute_features is featurize_trajectory's result on the card, bit for bit")
    out["features"] = list(X.shape)

    theta = 0.7
    rot = np.array([[np.cos(theta), -np.sin(theta), 0.0], [np.sin(theta), np.cos(theta), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    block = trajs[0][:API_ALIGN_FRAMES]
    moved = block @ rot.T + np.array([1.0, -0.5, 2.0], np.float32)
    aligned = timed("align_s", lambda: api.align_trajectory(np.concatenate([block, moved])))
    out["align_max_err_nm"] = float(np.abs(aligned[len(block):] - aligned[:len(block)]).max())
    _check(isinstance(aligned, np.ndarray) and out["align_max_err_nm"] <= API_ALIGN_TOL_NM,
           f"aligned copy {out['align_max_err_nm']} nm off the aligned block")
    A, meta_a = api.compute_features(traj, "phi_psi", info)
    expanded = api.trig_expand_periodic(A)
    out["trig_expand_vs_features_max"] = float(np.abs(expanded - X).max())
    _check(isinstance(expanded, np.ndarray) and out["trig_expand_vs_features_max"] <= 1e-6,
           "trig_expand_periodic of the angles is the features' (cos, sin) expansion")

    emb = timed("embedding_s", lambda: api.compute_universal_embedding(traj, info))
    metric = api.compute_universal_metric(traj, info)
    _check(isinstance(emb, np.ndarray) and emb.shape == (len(traj), 2)
           and bool(np.isfinite(emb).all()), f"universal embedding {emb.shape}")
    _check(metric.shape == (len(traj),) and bool(np.isfinite(metric).all()),
           "universal metric finite")

    labels = timed("cluster_s", lambda: api.cluster_microstates(
        [X[r * F:(r + 1) * F] for r in range(API_RUNGS)], n_states=API_STATES))
    _check(isinstance(labels, np.ndarray) and labels.shape == (len(traj),),
           "cluster_microstates: one label a frame")
    dtrajs = np.split(labels, API_RUNGS)
    msm = timed("msm_s", lambda: api.build_msm_from_labels(dtrajs, API_LAG, API_STATES))
    active = msm.active_states
    Ta, pia = msm.restricted_T(), msm.stationary_distribution[active]
    out["msm_active_states"] = int(len(active))
    out["msm_row_sum_off_1"] = float(np.abs(msm.transition_matrix.sum(1) - 1.0).max())
    _check(out["msm_row_sum_off_1"] <= 1e-10, "MSM rows sum to 1")
    Tn = Ta / Ta.sum(1, keepdims=True)
    macro, _ = timed("macrostates_s", lambda: api.compute_macrostates(Tn, 2, pia))
    pops = api.macrostate_populations(pia, macro)
    Tm = api.macro_transition_matrix(Tn, pia, macro)
    mfpt = api.macro_mfpt(Tn, pia, macro)
    off = ~np.eye(len(Tm), dtype=bool)
    out.update({"macrostate_populations": pops.tolist(),
                "macro_transition_matrix": Tm.tolist(), "macro_mfpt_frames": mfpt.tolist()})
    _check(len(pops) == 2 and abs(float(pops.sum()) - 1.0) <= 1e-10,
           f"macrostate populations {pops}")
    _check(float(np.abs(Tm.sum(1) - 1.0).max()) <= 1e-10, "macro T row-stochastic")
    _check(bool(np.isfinite(mfpt).all() and (mfpt[off] > 0).all()),
           f"macro MFPT {mfpt}")

    # the FES on the dihedral angles: the featurizer names every column
    # "phi_psi[k]" (phi first, then psi), so the pair is chosen on names
    # that say which is which
    n_phi = A.shape[1] // 2
    names = [f"phi{k}" for k in range(n_phi)] + [f"psi{k}" for k in range(n_phi)]
    i, j = api.select_fes_pair(names)
    out["fes_pair"] = [names[i], names[j]]
    out["fes_pair_on_featurizer_names"] = list(api.select_fes_pair(meta_a["columns"]))
    fes, picks = timed("fes_minima_s", lambda: api.generate_fes_and_pick_minima(
        A[:, i], A[:, j], periodic=(True, True), cv_names=(names[i], names[j])))
    out["fes_finite_fraction"] = float(fes.finite_fraction)
    out["fes_minima_frames"] = [len(v) for v in picks.values()]
    _check(out["fes_finite_fraction"] > 0.0, "FES has finite bins")
    _check(any(n > 0 for n in out["fes_minima_frames"]), "a minimum with frames")

    cs = timed("conformations_s", lambda: api.find_conformations_from_msm(
        Tn, n_macrostates=2, committor_tolerance=0.2))
    csv_path = api.conformations_to_csv(cs, root / "conformations.csv")
    json_path = api.conformations_to_json(cs, root / "conformations.json")
    n_rows = len(csv_path.read_text().splitlines()) - 1
    out["conformations"] = len(cs.conformations)
    _check(len(cs.conformations) >= 1 and n_rows == len(cs.conformations)
           == len(json.loads(json_path.read_text())["conformations"]),
           f"{n_rows} CSV rows for {len(cs.conformations)} conformations")

    phi0, psi0 = (np.degrees(A[:F, c]) for c in (i, j))
    kpi = timed("benchmark_s", lambda: benchmark.run_benchmark(phi0, psi0))
    out["benchmark"] = {k: kpi[k] for k in ("coverage", "transitions_cv1", "transitions_cv2",
                                             "finite_fraction", "n_frames")}
    _check(0.0 < kpi["coverage"] <= 1.0, f"coverage {kpi['coverage']}")
    _check(kpi["transitions_cv1"] >= 0 and kpi["transitions_cv2"] >= 0, "transitions")

    # 3. the one-shot analysis into a run directory, the plots, the dashboard
    run_dir = root / "run"
    m = timed("analyze_msm_s", lambda: api.analyze_msm(
        trajs, info, output_dir=run_dir if have_mpl else None, n_states=API_STATES,
        lag_time=API_LAG))
    if not have_mpl:
        m.save_analysis_results(run_dir)
    _check(m.features[0].dtype == np.float32 and m.its is not None and m.ck is not None
           and m.fes is not None, "analyze_msm: features on the host, ITS, CK, FES")
    out["analyze_msm_files"] = sorted(p.name for p in run_dir.iterdir())
    skipped = ["analyze_msm plots", "visualization plots", "fes_html / its_html",
               "export_static", "CLI dashboard", "serve"]
    if have_mpl:
        skipped = []
        from pmarlo_tpu_torch.main import main as cli
        from pmarlo_tpu_torch.visualization import fes_html, its_html
        from pmarlo_tpu_torch.visualization import plots as P
        from pmarlo_tpu_torch.webapp import export_static, serve

        for name in ("fes.png", "its.png", "ck.png"):
            _check((run_dir / name).stat().st_size > 0, f"analyze_msm wrote {name}")
        plots = root / "plots"
        timed("plots_s", lambda: [
            P.plot_acceptance_matrix(res, plots / "acceptance.png"),
            P.plot_ramachandran(phi0, psi0, plots / "ramachandran.png"),
            P.plot_committors(cs.tpt, plots / "committors.png"),
            P.plot_flux_network(cs.tpt, plots / "flux_network.png"),
            P.plot_its(m.its, plots / "its.png"), P.plot_ck(m.ck, plots / "ck.png")])
        out["plots"] = {p.name: p.stat().st_size for p in sorted(plots.iterdir())}
        _check(len(out["plots"]) == 6 and all(out["plots"].values()), f"plots {out['plots']}")
        pages = timed("interactive_s", lambda: [fes_html(m.fes, root / "fes.html"),
                                                 its_html(m.its, root / "its.html")])
        _check(all("http://" not in p and "https://" not in p for p in pages),
               "the interactive pages are self-contained")
        page = timed("export_s", lambda: export_static(run_dir, root / "dashboard.html")
                     .read_text())
        _check(timed("cli_dashboard_s", lambda: cli(
            ["dashboard", str(run_dir), "--export", str(root / "cli.html")])) == 0,
               "the CLI's dashboard exits 0")
        _check((root / "cli.html").read_bytes() == (root / "dashboard.html").read_bytes(),
               "the CLI's page is export_static's, byte for byte")
        titles = _dashboard_titles(page)
        out["dashboard_cards"] = titles
        out["dashboard_bytes"] = len(page)
        _check(all(any(t.startswith(c) for t in titles) for c in DASHBOARD_CARDS),
               f"dashboard cards {titles}")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        threading.Thread(target=serve, args=(run_dir,), kwargs={"port": port},
                         daemon=True).start()
        t0 = time.perf_counter()
        while True:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}", timeout=10) as r:
                    status, served = r.status, r.read().decode()
                break
            except urllib.error.URLError as exc:
                _check(isinstance(exc.reason, ConnectionRefusedError)
                       and time.perf_counter() - t0 < 10.0, f"the dashboard server: {exc}")
                time.sleep(0.1)
        walls["serve_get_s"] = time.perf_counter() - t0
        out["serve_status"] = status
        _check(status == 200 and _dashboard_titles(served) == titles,
               f"served page: status {status}, cards {_dashboard_titles(served)}")
    out["steps_not_run"] = skipped
    tmp.cleanup()
    walls["phase_s"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    _line("phase 26 api and reports", out)
    return out


def _multi_device_config(seed: int = 0):
    from pmarlo_tpu_torch.remd.remd import RemdConfig

    return RemdConfig(n_replicas=N_REPLICAS, t_min=300.0, t_max=450.0,
                      exchange_frequency=EXCHANGE_FREQUENCY,
                      report_interval=EXCHANGE_FREQUENCY, dt_ps=DT_PS, seed=seed)


def _multi_device_protein_config():
    from pmarlo_tpu_torch.remd.remd import RemdConfig

    return RemdConfig(n_replicas=PROTEIN_REPLICAS, t_min=300.0, t_max=330.0,
                      exchange_frequency=MD_PROTEIN_STEPS, report_interval=50,
                      dt_ps=PROTEIN_DT_PS, seed=0, friction_per_ps=SHORT_RUN_FRICTION)


def _protein_setup():
    from pmarlo_tpu_torch.data.chignolin import chignolin_assembly
    from pmarlo_tpu_torch.md.setup import build_implicit_setup

    return build_implicit_setup(chignolin_assembly(PROTEIN_COPIES), gb_model="gbn2",
                                constraints="hbonds", device="cuda")


def _deeptica_step(params, z0, zt, mesh=None):
    """One SGD(lr=1) step of the VAMP-2 loss at DeepTICAConfig's defaults:
    the data-parallel step under ``mesh``, else the serial math on the
    card (the loss of the whole batch, its gradient)."""
    from pmarlo_tpu_torch.ml.deeptica import DeepTICAConfig, mlp_apply
    from pmarlo_tpu_torch.ml.losses import vamp2_loss
    from pmarlo_tpu_torch.parallel import make_data_parallel_step

    cfg = DeepTICAConfig()
    p = [{k: torch.as_tensor(v, device="cuda") for k, v in layer.items()} for layer in params]
    if mesh is not None:
        step = make_data_parallel_step(cfg, lambda leaves: torch.optim.SGD(leaves, lr=1.0),
                                       mesh)
        p, _, loss = step(p, None, z0, zt)
    else:
        leaves = [t.requires_grad_(True) for layer in p for t in layer.values()]
        z0, zt = (torch.as_tensor(z, device="cuda") for z in (z0, zt))
        loss, _ = vamp2_loss(mlp_apply(p, z0, cfg.activation), mlp_apply(p, zt, cfg.activation),
                             ridge=cfg.vamp_ridge, alpha=cfg.vamp_alpha)
        opt = torch.optim.SGD(leaves, lr=1.0)
        loss.backward()
        opt.step()
    return float(loss.detach()), [{k: v.detach().cpu().numpy() for k, v in layer.items()}
                                  for layer in p]


def _water_slab_system(tilt: bool):
    """The 24^3 TIP3P box (41,472 atoms, 7.54 nm, nx = 8 at the 0.9 nm
    cutoff); ``tilt``: sheared by the tilt ratios of JAX's dry run."""
    from pmarlo_tpu_torch.data.water import water_box_structure
    from pmarlo_tpu_torch.md.forcefield import build_system

    structure, box = water_box_structure(MD_WATER_SIDE)
    shear = None
    if tilt:
        rbx, rcx, rcy = MD_TILT_RATIOS
        shear = (rbx * box[0], rcx * box[0], rcy * box[1])
    return build_system(structure, box=box, tilt=shear, cutoff=EXPLICIT_CUTOFF,
                        hydrogen_mass=None, device="cuda")


def _slab_sweeps(out: dict, tag: str, fn, serial, x: torch.Tensor) -> None:
    """One rank's slab launch against its plain version (this rank's
    partial sums) and the whole evaluation against the unsharded kernel;
    ms a sweep of each, the ranks timing in turns (the other waits at a
    barrier), the pairs inside the cutoff of the slab, the scratch of
    each."""
    import torch.distributed as dist

    from pmarlo_tpu_torch.md.cells import bin_atoms

    order, cs, _, xw = bin_atoms(fn.grid, x[None])
    order, cs = order.contiguous(), cs.contiguous()
    ek, fk = fn.sweep(xw, order, cs)
    ep, fp = fn.sweep_reference(xw, order, cs)
    _gate(out, f"{tag}_slab_vs_plain", ek.sum(-1), fk, ep.sum(-1), fp)
    out[f"{tag}_slab_vs_plain_force_max_abs_err"] = float((fk - fp).abs().max())
    e, f = fn(x)
    e0, f0 = serial(x)
    _gate(out, f"{tag}_slab_vs_unsharded", e[None], f, e0[None], f0)
    for turn in range(dist.get_world_size()):
        dist.barrier()
        if turn != dist.get_rank():
            continue
        out[f"{tag}_slab_ms"] = _cuda_ms(lambda: fn.sweep(xw, order, cs), 20)
        out[f"{tag}_unsharded_ms"] = _cuda_ms(lambda: serial.sweep(xw, order, cs), 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn.sweep_reference(xw, order, cs)
        torch.cuda.synchronize()
        out[f"{tag}_plain_ms"] = (time.perf_counter() - t0) * 1e3
    dist.barrier()
    sl = fn.slab
    local, _ = sl.atoms(order[0], cs[0])
    out[f"{tag}_slab_atoms"] = int(local.shape[0])
    out[f"{tag}_slab_pairs"] = sum(int(ai.numel()) for ai, *_ in fn.half_shell(
        xw[0], order[0], cs[0], home=(sl.lo, sl.hi)))
    out[f"{tag}_scratch_bytes"] = fn.scratch_bytes(x)
    out[f"{tag}_unsharded_scratch_bytes"] = serial.scratch_bytes(x)
    _check(out[f"{tag}_scratch_bytes"] < out[f"{tag}_unsharded_scratch_bytes"],
           f"{tag}: a rank's scratch is not below the unsharded one")


def _sha256(x: torch.Tensor) -> str:
    """The digest of a tensor's bytes (two ranks' copies compared bit for bit)."""
    return hashlib.sha256(x.detach().cpu().numpy().tobytes()).hexdigest()


def _multi_device_rank(rank: int, world: int, store: str, tmp: str) -> None:
    """One rank of phase 27 (spawned): gloo over a FileStore, on cuda:0."""
    import pickle

    import torch.distributed as dist

    import pmarlo_tpu_torch  # noqa: F401  (pins float32 matmuls)
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.md.cell_force import build_cell_force_fn
    from pmarlo_tpu_torch.md.constraints import build_h_constraints, strip_constrained_bonded
    from pmarlo_tpu_torch.md.forcefield import build_system
    from pmarlo_tpu_torch.md.integrate import run_md, thermalize
    from pmarlo_tpu_torch.md.minimize import minimize_energy
    from pmarlo_tpu_torch.parallel import replica_mesh
    from pmarlo_tpu_torch.remd.checkpoint import load_checkpoint, save_checkpoint
    from pmarlo_tpu_torch.remd.remd import ReplicaExchange

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    out = {"rank": rank}
    with np.load(f"{tmp}/inputs.npz") as d:
        inputs = {k: d[k] for k in d.files}
    layers = [{"w": inputs[f"w{i}"], "b": inputs[f"b{i}"]}
              for i in range(sum(k.startswith("w") for k in inputs))]
    mesh = replica_mesh(world)
    out.update(backend=dist.get_backend(), world=dist.get_world_size(),
               device=str(torch.cuda.current_device()))
    walls = {}

    # 1. alanine, 32 rungs on the plain path, and the checkpoint round trip
    t0 = time.perf_counter()
    system, _ = build_system(alanine_dipeptide_structure(), gb_model="gbn2", device="cuda")
    remd = ReplicaExchange(system, torch.as_tensor(inputs["alanine_x"], device="cuda"),
                           _multi_device_config(), minimize=False, mesh=mesh)
    out["alanine"] = remd.run(MD_ALANINE_STEPS)
    walls["alanine_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path = save_checkpoint(remd, f"{tmp}/remd.npz", extra={"ranks": world})
    back, _, extra = load_checkpoint(path, system, mesh=mesh)
    same = [torch.equal(getattr(back.state, k), getattr(remd.state, k))
            for k in ("positions", "velocities", "seeds")]
    out["checkpoint"] = {
        "state_bitwise": all(same), "ids_bitwise": bool(torch.equal(back.replica_ids,
                                                                    remd.replica_ids)),
        "attempts": back._attempts_done, "step": back.state.step, "extra": extra,
        "local_rungs": int(back.state.positions.shape[0])}
    walls["checkpoint_s"] = time.perf_counter() - t0

    # 2. the protein through rows 3-5, 4 rungs a rank
    t0 = time.perf_counter()
    setup = _protein_setup()
    _reset_counts()
    premd = ReplicaExchange(setup.system, torch.as_tensor(inputs["protein_x"], device="cuda"),
                            _multi_device_protein_config(), force_fn=setup.force_fn,
                            constraints=setup.constraints, minimize=False, mesh=mesh)
    out["protein"] = premd.run(MD_PROTEIN_STEPS)
    out["protein_launches"] = {k: _counts()[k] for k in PAIR_KERNELS}
    walls["protein_s"] = time.perf_counter() - t0

    # 3. the water box in x-slabs: run_md through the slab launch (the
    # launches counted), then each mode against the unsharded kernel and
    # against its plain version
    t0 = time.perf_counter()
    wsys, wx = _water_slab_system(tilt=False)
    # the lattice relaxes through the full system's slab sweep first
    wx, _ = minimize_energy(wsys, wx, force_fn=build_cell_force_fn(wsys, mesh=mesh),
                            max_iterations=MD_WATER_FIRE)
    # every rank holds the whole state: its copy must stay the same bits
    out["water_fire_sha256"] = _sha256(wx)
    spec = build_h_constraints(wsys)
    md_fn = build_cell_force_fn(strip_constrained_bonded(wsys), mesh=mesh)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    state = thermalize(wsys, wx, gen, 300.0)
    _reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, frames = run_md(wsys, state, n_steps=MD_WATER_STEPS, dt=DT_PS, friction=1.0,
                           temperature_K=300.0, force_fn=md_fn, constraints=spec,
                           report_interval=MD_WATER_STEPS)
    torch.cuda.synchronize()
    out["water_ms_per_step"] = (time.perf_counter() - t1) / MD_WATER_STEPS * 1e3
    out["water_md_sha256"] = _sha256(state.positions)
    out["water_launches"] = _counts()["cell_force_slab"]
    out["water_unsharded_launches"] = _counts()["cell_force"]
    out["water_temperature"] = float(frames["temperature"][-1])
    out["water_atoms"] = wsys.n_atoms
    out["water_cells"] = [md_fn.grid.nx, md_fn.grid.ny, md_fn.grid.nz]
    out["local_shapes"] = md_fn.local_shapes
    x = state.positions
    for tag, elec in (("rf", "rf"), ("pme", "pme")):
        _slab_sweeps(out, tag, build_cell_force_fn(wsys, electrostatics=elec, mesh=mesh),
                     build_cell_force_fn(wsys, electrostatics=elec), x)
    ssys, sx = _water_slab_system(tilt=True)
    _slab_sweeps(out, "sheared", build_cell_force_fn(ssys, mesh=mesh),
                 build_cell_force_fn(ssys), sx)
    walls["water_s"] = time.perf_counter() - t0

    # 4. the data-parallel DeepTICA step
    t0 = time.perf_counter()
    out["deeptica"] = _deeptica_step(layers, torch.as_tensor(inputs["z0"], device="cuda"),
                                     torch.as_tensor(inputs["zt"], device="cuda"), mesh)
    walls["deeptica_s"] = time.perf_counter() - t0
    out["walls_s"] = walls
    with open(f"{tmp}/rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()


def _same_remd(out: dict, tag: str, res, ref) -> None:
    """Phase 27's gate of a sharded run against the one-rank run: identical
    ids and acceptance, frames within 1e-4 nm."""
    ids = bool(np.array_equal(res.replica_ids, ref.replica_ids))
    acc = bool(np.array_equal(res.acceptance_matrix, ref.acceptance_matrix, equal_nan=True))
    dx = float(np.abs(res.positions - ref.positions).max())
    de = float(np.abs(res.potential_energy - ref.potential_energy).max())
    out[tag] = {"replica_ids_identical": ids, "acceptance_identical": acc,
                "frames_max_abs_dx_nm": dx, "energies_max_abs_diff": de,
                "mean_acceptance": res.mean_acceptance, "frames": list(res.positions.shape)}
    _check(ids and acc, f"{tag}: sharded decisions differ from the one-rank run")
    _check(dx <= 1e-4, f"{tag}: sharded frames {dx} nm from the one-rank run")


def phase_multi_device() -> dict:
    """Two ranks on the one card (gloo, CUDA tensors, a FileStore in a
    temporary directory), spawned while this process runs the one-rank
    references beside them."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.md.forcefield import build_system
    from pmarlo_tpu_torch.md.minimize import minimize_energy
    from pmarlo_tpu_torch.ml.deeptica import DeepTICAConfig
    from pmarlo_tpu_torch.remd.remd import ReplicaExchange

    out = {"ranks": MD_RANKS}
    walls = {}
    t0 = time.perf_counter()
    system, ax = build_system(alanine_dipeptide_structure(), gb_model="gbn2", device="cuda")
    ax = minimize_energy(system, ax)[0]
    setup = _protein_setup()
    px = minimize_energy(setup.system, setup.positions, force_fn=setup.minimize_force_fn)[0]
    cfg = DeepTICAConfig()
    S, T, K = MD_DEEPTICA
    rng = np.random.default_rng(27)
    walk = np.cumsum(rng.normal(0.0, 0.1, (S, T, K)), axis=1).astype(np.float32)
    z0 = walk[:, :-cfg.lag].reshape(-1, K)
    zt = walk[:, cfg.lag:].reshape(-1, K)
    sizes = [K, *cfg.hidden, cfg.n_out]
    layers = [{"w": rng.normal(0.0, np.sqrt(2.0 / (a + b)), (a, b)).astype(np.float32),
               "b": np.zeros(b, np.float32)} for a, b in zip(sizes[:-1], sizes[1:])]
    walls["inputs_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/inputs.npz", alanine_x=ax.cpu().numpy(), protein_x=px.cpu().numpy(),
                 z0=z0, zt=zt, **{f"{k}{i}": layer[k] for i, layer in enumerate(layers)
                                  for k in ("w", "b")})
        t0 = time.perf_counter()
        ctx = mp.start_processes(_multi_device_rank, args=(MD_RANKS, f"{tmp}/store", tmp),
                                 nprocs=MD_RANKS, join=False, start_method="spawn")
        try:
            # the one-rank references, while the ranks run
            t1 = time.perf_counter()
            ref = ReplicaExchange(system, ax, _multi_device_config(), device="cuda",
                                  minimize=False).run(MD_ALANINE_STEPS)
            walls["alanine_one_rank_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            pref = ReplicaExchange(setup.system, px, _multi_device_protein_config(),
                                   device="cuda", force_fn=setup.force_fn,
                                   constraints=setup.constraints,
                                   minimize=False).run(MD_PROTEIN_STEPS)
            walls["protein_one_rank_s"] = time.perf_counter() - t1
            dloss, dparams = _deeptica_step(layers, z0, zt)
        finally:
            while not ctx.join():
                pass
        walls["ranks_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(MD_RANKS):
            with open(f"{tmp}/rank{r}.pkl", "rb") as fh:
                ranks.append(pickle.load(fh))
    r0 = ranks[0]
    out.update(backend=r0["backend"], world=r0["world"],
               rank_devices=[r["device"] for r in ranks])
    print(f"phase 27: backend {r0['backend']}, world size {r0['world']}", flush=True)
    _check(r0["backend"] == "gloo" and r0["world"] == MD_RANKS, "the ranks' process group")
    for r, res in enumerate(ranks):
        _same_remd(out, f"alanine_rank{r}", res["alanine"], ref)
        _same_remd(out, f"protein_rank{r}", res["protein"], pref)
        ck = res["checkpoint"]
        _check(ck["state_bitwise"] and ck["ids_bitwise"]
               and ck["local_rungs"] == N_REPLICAS // MD_RANKS
               and ck["attempts"] == MD_ALANINE_STEPS // EXCHANGE_FREQUENCY,
               f"rank {r}: checkpoint round trip {ck}")
        _check(all(n > 0 for n in res["protein_launches"].values()),
               f"rank {r}: pair launches {res['protein_launches']}")
        _check(res["water_launches"] >= MD_WATER_STEPS and res["water_unsharded_launches"] == 0,
               f"rank {r}: slab launches {res['water_launches']}")
        _check(all(res[k] == r0[k] for k in ("water_fire_sha256", "water_md_sha256")),
               f"rank {r}: its copy of the water box left rank 0's after FIRE or run_md")
        loss, params = res["deeptica"]
        _check(abs(loss - dloss) <= 1e-4, f"rank {r}: DeepTICA loss {loss} vs {dloss}")
        for mine, theirs in zip(params, dparams):
            for k in ("w", "b"):
                _check(np.allclose(mine[k], theirs[k], atol=5e-6, rtol=1e-5),
                       f"rank {r}: DeepTICA {k} after the step")
        out[f"rank{r}"] = {k: v for k, v in res.items()
                           if k not in ("alanine", "protein", "deeptica")}
        out[f"rank{r}"]["deeptica_loss"] = loss
    out["checkpoint"] = r0["checkpoint"]
    out["deeptica_one_rank_loss"] = dloss
    out["walls_s"] = walls
    out["water_ranks_in_step"] = True       # the sha256 checks above
    out["slab_launches"] = sum(r["water_launches"] for r in ranks)
    out["protein_pair_launches_per_rank"] = [r["protein_launches"] for r in ranks]
    _line("phase 27 multi-device", out)
    out["slab_max_abs_err"] = max(r[f"{t}_slab_vs_plain_force_max_abs_err"]
                                  for r in ranks for t in ("rf", "pme", "sheared"))
    out["slab_bound"] = _periodic_bound(r0["rf_slab_pairs"], 1, r0["rf_slab_atoms"])
    out["slab_ms"], out["slab_plain_ms"] = r0["rf_slab_ms"], r0["rf_plain_ms"]
    return out


def _nblist_parity(out: dict, tag: str, system, tables, x: torch.Tensor, newton_fn, ordered_fn,
                   twin64=None) -> None:
    """Phase 28 (a) at positions ``x (N, 3)``: ``potential_energy_nb`` and its
    autograd forces, the list at ``GB_CUTOFF`` without skin (the capacity
    raised to ``n_max`` where the default would saturate), against the cut
    pair path's kernels, Newton (rows 7 + 10) and ordered (rows 6 + 10), to
    ``NB_PARITY_REL`` of the energy and of the largest force. With
    ``twin64``, the pair path's float64 plain version: the float64 nblist
    evaluation is held to it at the same gate (the two functions' parity),
    and each float32 path's distance from it is printed. At minimized
    positions (max |F| ~ 10^2 kJ/mol/nm) float32 rounding alone puts both
    float32 paths ~1.5e-4 of it from the float64 evaluation (a 276-atom CPU
    run of the same comparison), so there the float32 paths are held on
    their energies only."""
    from pmarlo_tpu_torch.md import nblist as NB

    N = system.n_atoms
    cap = NB._default_capacity(N, GB_CUTOFF, 0.0)
    nl = NB.build_neighbor_list(x, GB_CUTOFF, cap)
    n_max = int(nl.n_max)
    out[f"{tag}_parity_capacity_default"], out[f"{tag}_parity_n_max"] = cap, n_max
    if n_max > cap:
        nl = NB.build_neighbor_list(x, GB_CUTOFF, n_max)
    scales = NB._pair_scales(nl, tables)
    e_nb, f_nb = NB._energy_and_forces(system, x, nl, scales, None)
    out[f"{tag}_nblist_energy_kj_mol"] = float(e_nb)
    out[f"{tag}_max_force"] = float(f_nb.abs().max())
    if twin64 is not None:
        e64, f64 = twin64.reference(x.double()[None])
        e64, twin64_f = float(e64[0]), f64[0]
        e_nb64, f_nb64 = NB._energy_and_forces(system, x.double(), nl, scales, None)
        out[f"{tag}_nblist_vs_float64_force_rel_err"] = _rel(f_nb.double(), twin64_f)
        out[f"{tag}_nblist64_vs_float64_energy_rel_err"] = abs(float(e_nb64) - e64) / abs(e64)
        out[f"{tag}_nblist64_vs_float64_force_rel_err"] = _rel(f_nb64, twin64_f)
        _check(out[f"{tag}_nblist64_vs_float64_energy_rel_err"] <= NB_PARITY_REL
               and out[f"{tag}_nblist64_vs_float64_force_rel_err"] <= NB_PARITY_REL,
               f"{tag}: float64 nblist vs the pair path's float64 version")
    for path, fn in (("newton", newton_fn), ("ordered", ordered_fn)):
        e_p, f_p = fn(x)
        rel_e = abs(float(e_nb) - float(e_p)) / abs(float(e_p))
        rel_f = _rel(f_nb, f_p)
        out[f"{tag}_{path}_energy_kj_mol"] = float(e_p)
        out[f"{tag}_nblist_vs_{path}_energy_rel_err"] = rel_e
        out[f"{tag}_nblist_vs_{path}_force_rel_err"] = rel_f
        _check(rel_e <= NB_PARITY_REL and (twin64 is not None or rel_f <= NB_PARITY_REL),
               f"{tag}: nblist vs the {path} pair path at {GB_CUTOFF} nm: energy {rel_e}, "
               f"force {rel_f}")
        if twin64 is not None:
            out[f"{tag}_{path}_vs_float64_force_rel_err"] = _rel(f_p.double(), twin64_f)
    out[f"{tag}_nblist_eval_ms"] = _cuda_ms(
        lambda: NB._energy_and_forces(system, x, nl, scales, None), 5)


def phase_neighbor_list(px_min: torch.Tensor) -> dict:
    """Phase 28: the neighbor-listed GB path and the roll layouts at full
    width, 3,726 atoms (phase 7's minimized assembly; the System built
    with its dense GBn2 neck tables, which the list's Born integral reads).

    The nblist path launches no kernel: its numbers stand beside the pair
    path's (rows 6, 7 and 10), which cuts every pair term at the same
    distance. Every launch of the phase counts toward those rows."""
    from pmarlo_tpu_torch.data.chignolin import chignolin_assembly
    from pmarlo_tpu_torch.md import forces
    from pmarlo_tpu_torch.md import nblist as NB
    from pmarlo_tpu_torch.md.bonded_roll import build_rolled_bonded
    from pmarlo_tpu_torch.md.constraints import (
        RolledConstraintSpec, build_h_constraints, constraint_violation, rattle,
        rattle_rolled, shake, shake_rolled, strip_constrained_bonded)
    from pmarlo_tpu_torch.md.forcefield import build_system
    from pmarlo_tpu_torch.md.integrate import run_md, thermalize
    from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn, kernel_name

    torch.cuda.synchronize()
    _reset_counts()
    walls = {}
    t0 = time.perf_counter()
    system, _ = build_system(chignolin_assembly(PROTEIN_COPIES), gb_model="gbn2",
                             device="cuda", dense_scales=True)
    x = px_min.detach().clone()
    N = system.n_atoms
    _check(x.shape == (N, 3) and system.gb_neck_m0 is not None,
           "phase 28 runs on phase 7's assembly with its neck tables")
    tables = NB.make_exclusion_tables(system)
    walls["system_and_tables_s"] = time.perf_counter() - t0
    out = {"atoms": N, "card": _card(), "exclusion_table_width": int(tables.partner.shape[1])}

    # (a) the list at the cut pair path's cutoff, no skin, against rows 6/7 + 10:
    # at the minimized positions in float64 too, and at warmed positions
    cut = dict(gb_cutoff=GB_CUTOFF, order_from=x, bonded="window")
    newton_fn = build_pair_force_fn(system, **cut)
    ordered_fn = build_pair_force_fn(system, newton=False, **cut)
    twin64 = build_pair_force_fn(system, gb_cutoff=GB_CUTOFF, dtype=torch.float64)
    _check(newton_fn.mode == "newton" and ordered_fn.mode == "culled"
           and newton_fn.bonded == ordered_fn.bonded == "window",
           "phase 28's pair paths are rows 7 and 6 with the bonded kernel")
    _nblist_parity(out, "min", system, tables, x, newton_fn, ordered_fn, twin64)
    out["newton_eval_ms"] = _cuda_ms(lambda: newton_fn(x), 5)

    # (b) dynamics: warm on row 7 at 2.0 nm, then run_md_nb and row 7 from one state
    row7 = build_pair_force_fn(system, gb_cutoff=NB_CUTOFF, order_from=x, bonded="window")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(28)
    warm = dict(dt=NB_DT_PS, temperature_K=300.0, force_fn=row7)
    state, _ = run_md(system, thermalize(system, x, gen, 300.0), n_steps=NB_WARM_STEPS,
                      friction=SHORT_RUN_FRICTION, report_interval=NB_WARM_STEPS, **warm)
    _nblist_parity(out, "warm", system, tables, state.positions, newton_fn, ordered_fn)
    cap = NB._default_capacity(N, NB_CUTOFF, NB_SKIN)
    out["md_capacity"] = cap
    out["md_list_n_max_start"] = int(NB.build_neighbor_list(state.positions, NB_CUTOFF + NB_SKIN,
                                                            cap).n_max)
    out["list_build_ms"] = _cuda_ms(
        lambda: NB.build_neighbor_list(state.positions, NB_CUTOFF + NB_SKIN, cap), 5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    st_nb, frames = NB.run_md_nb(system, state, n_steps=NB_STEPS, dt=NB_DT_PS,
                                 friction=NB_FRICTION, temperature_K=300.0,
                                 report_interval=NB_REPORT, cutoff=NB_CUTOFF, skin=NB_SKIN,
                                 rebuild_interval=NB_REBUILD)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    out["nblist_peak_device_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["nblist_ms_per_step"] = wall / NB_STEPS * 1e3
    out["md_list_n_max_end"] = int(NB.build_neighbor_list(st_nb.positions, NB_CUTOFF + NB_SKIN,
                                                          cap).n_max)
    temps = [float(t) for t in frames["temperature"]]
    last = NB_STEPS // NB_REPORT // 2
    state_ratio = float(np.mean(temps[-last:]) / 300.0)
    out.update({"nblist_report_temperature_K": temps,
                "nblist_report_energy_kj_mol": [float(e) for e in frames["potential_energy"]],
                "nblist_state_kinetic_over_target_last_200_steps": state_ratio})
    _check(bool(torch.isfinite(frames["positions"]).all())
           and bool(torch.isfinite(frames["potential_energy"]).all()), "run_md_nb frames finite")
    _check(150.0 < temps[-1] < 450.0, f"run_md_nb's last report {temps[-1]} K")
    _check(NB_T_BAND[0] <= state_ratio <= NB_T_BAND[1],
           f"run_md_nb's state kinetic/target over the last 200 steps {state_ratio}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    run_md(system, state, n_steps=NB_ROW7_STEPS, friction=NB_FRICTION,
           report_interval=NB_ROW7_STEPS, **warm)
    torch.cuda.synchronize()
    out["row7_ms_per_step"] = (time.perf_counter() - t2) / NB_ROW7_STEPS * 1e3
    out["row7_peak_device_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    walls["dynamics_s"] = time.perf_counter() - t1

    # (c) the roll layouts
    t3 = time.perf_counter()
    rolled = build_rolled_bonded(system)
    with torch.enable_grad():
        y = x.detach().requires_grad_(True)
        e_r = rolled(y)
        (g_r,) = torch.autograd.grad(e_r, y)
        z = x.detach().requires_grad_(True)
        e_i = (forces.bond_energy(system, z) + forces.angle_energy(system, z)
               + forces.torsion_energy(system, z))
        (g_i,) = torch.autograd.grad(e_i, z)
    e_r, e_i = float(e_r.detach()), float(e_i.detach())
    out["rolled_bonded_energy_rel_err"] = abs(e_r - e_i) / abs(e_i)
    out["rolled_bonded_force_rel_err"] = float((g_r - g_i).abs().max() / g_i.abs().max())
    _check(out["rolled_bonded_energy_rel_err"] <= 1e-4
           and out["rolled_bonded_force_rel_err"] <= 1e-4,
           f"rolled bonded terms: {out['rolled_bonded_energy_rel_err']}, "
           f"{out['rolled_bonded_force_rel_err']}")
    spec_r = build_h_constraints(system, layout="rolled")
    spec_i = build_h_constraints(system)
    _check(isinstance(spec_r, RolledConstraintSpec)
           and spec_r.n_constraints == spec_i.n_constraints, "the two layouts' constraints")
    rng = np.random.default_rng(28)
    x_new = x + torch.as_tensor(rng.normal(0.0, 0.003, (N, 3)), dtype=x.dtype, device=x.device)
    v = torch.as_tensor(rng.normal(0.0, 1.0, (N, 3)), dtype=x.dtype, device=x.device)
    xs_r, xs_i = shake_rolled(spec_r, x_new, x), shake(spec_i, x_new, x)
    vs_r, vs_i = rattle_rolled(spec_r, v, xs_i), rattle(spec_i, v, xs_i)
    out["shake_rolled_vs_indexed_max_dx_nm"] = float((xs_r - xs_i).abs().max())
    out["rattle_rolled_vs_indexed_max_dv_nm_ps"] = float((vs_r - vs_i).abs().max())
    _check(out["shake_rolled_vs_indexed_max_dx_nm"] <= 1e-5
           and out["rattle_rolled_vs_indexed_max_dv_nm_ps"] <= 1e-5,
           "shake_rolled / rattle_rolled vs shake / rattle")
    md_system = strip_constrained_bonded(system)
    fn_md = build_pair_force_fn(md_system, **cut)
    for tag, spec in (("rolled", spec_r), ("indexed", spec_i)):
        gen.manual_seed(280)
        st = thermalize(system, x, gen, 300.0)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        st, fr = run_md(system, st, n_steps=ROLLED_STEPS, dt=ROLLED_DT_PS, friction=NB_FRICTION,
                        temperature_K=300.0, report_interval=ROLLED_STEPS // 2, force_fn=fn_md,
                        constraints=spec)
        torch.cuda.synchronize()
        out[f"{tag}_constrained_ms_per_step"] = (time.perf_counter() - t4) / ROLLED_STEPS * 1e3
        dev = float(constraint_violation(spec, fr["positions"]))
        out[f"{tag}_max_constraint_deviation_nm"] = dev
        _check(bool(torch.isfinite(fr["positions"]).all()) and dev <= 1e-4,
               f"{tag} constrained run_md: deviation {dev} nm")
    walls["rolled_s"] = time.perf_counter() - t3

    counts = _counts()
    out["launches"] = {k: v for k, v in counts.items() if v}
    rows = {"6": [kernel_name(s, "culled") for s in ("born", "energy", "force")],
            "7": [kernel_name(s, "newton") for s in ("born", "energy", "force")],
            "10": ["bonded"]}
    _check(all(counts[k] > 0 for names in rows.values() for k in names),
           f"phase 28 launched rows 6, 7 and 10: {out['launches']}")
    _check(set(out["launches"]) <= {k for names in rows.values() for k in names},
           f"phase 28 launched other kernels: {out['launches']}")
    walls["phase_s"] = time.perf_counter() - t0
    out["walls_s"] = walls
    _line("phase 28 neighbor list", out)
    return out


def temperature_study() -> dict:
    """``python3 chip_smoke.py --temperature-study``: the two temperatures of
    the 61,824-atom constrained run at 4 fs and at 2 fs, 6 ps each from one
    minimized start and one seed, by picosecond: ``run_md``'s reported
    kinetic/target ratio (velocities after the trailing half kick, mean of a
    picosecond's frames) and the state's mid-step ratio at the picosecond's
    end. If the reported deficit is a discretisation error of order
    (w dt)^2 / 4 a mode it falls about fourfold from 4 fs to 2 fs while the
    mid-step ratio stays at 1. A measurement: nothing is gated."""
    from pmarlo_tpu_torch.md.constraints import build_h_constraints, strip_constrained_bonded
    from pmarlo_tpu_torch.md.integrate import instantaneous_temperature, run_md, thermalize
    from pmarlo_tpu_torch.md.minimize import minimize_energy
    from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn

    system, x0 = _large_system(LARGE_COPIES)
    cut = dict(tile=LARGE_TILE, gb_cutoff=GB_CUTOFF, order_from=x0)
    spec = build_h_constraints(system)
    fn_md = build_pair_force_fn(strip_constrained_bonded(system), **cut)
    x_min, _ = minimize_energy(system, x0, force_fn=build_pair_force_fn(system, **cut),
                               max_iterations=LARGE_FIRE)
    out = {"atoms": system.n_atoms, "ps": STUDY_PS}
    for dt in (0.004, 0.002):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(17)
        state = thermalize(system, x_min, gen, 300.0)
        reported, mid = [], []
        per_ps = round(1.0 / dt)
        for _ in range(STUDY_PS):
            state, seg = run_md(system, state, n_steps=per_ps, force_fn=fn_md,
                                report_interval=per_ps // 10, dt=dt, friction=1.0,
                                temperature_K=300.0, constraints=spec)
            reported.append(float(seg["temperature"].mean() / 300.0))
            mid.append(float(instantaneous_temperature(
                system, state.velocities, spec.n_constraints) / 300.0))
        _check(bool(torch.isfinite(state.positions).all()), f"dt={dt} positions finite")
        tag = f"dt_{round(dt * 1e3)}fs"
        out[f"{tag}_reported_by_ps"] = reported
        out[f"{tag}_mid_step_by_ps"] = mid
        out[f"{tag}_reported_deficit_last_2ps"] = 1.0 - 0.5 * (reported[-1] + reported[-2])
        out[f"{tag}_mid_step_last_2ps"] = 0.5 * (mid[-1] + mid[-2])
    out["deficit_ratio_4fs_over_2fs"] = (out["dt_4fs_reported_deficit_last_2ps"]
                                         / out["dt_2fs_reported_deficit_last_2ps"])
    _line("temperature study", out)
    return out


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch sees none")
    import pmarlo_tpu_torch  # noqa: F401  (pins float32 matmuls)
    if sys.argv[1:] == ["--temperature-study"]:
        temperature_study()
        print(_card())
        return
    if sys.argv[1:]:
        raise SystemExit(f"unknown arguments {sys.argv[1:]}")
    from pmarlo_tpu_torch.data import alanine_dipeptide_structure
    from pmarlo_tpu_torch.md.forcefield import build_system
    from pmarlo_tpu_torch.md.minimize import minimize_energy

    t_start = time.perf_counter()
    build = _timed("1 build", phase_build)

    def alanine():
        system, positions = build_system(
            alanine_dipeptide_structure(), gb_model="gbn2", device="cuda"
        )
        return system, positions, minimize_energy(system, positions)[0]

    system, positions, x_min = _timed("alanine system", alanine)
    kern = _timed("2 kernel", phase_kernel_vs_plain, system, x_min)
    _timed("3 thermostat", phase_thermostat, system, x_min)
    main_path = _timed("4 main path", phase_main_path, system, positions)
    times = _timed("5 times", phase_times, system, positions, main_path)

    from pmarlo_tpu_torch.data.chignolin import chignolin_assembly
    from pmarlo_tpu_torch.md.pair_force import build_pair_force_fn

    def assembly():
        protein, ppos = build_system(
            chignolin_assembly(PROTEIN_COPIES), gb_model="gbn2", device="cuda",
            dense_scales=False,
        )
        return protein, minimize_energy(protein, ppos,
                                        force_fn=build_pair_force_fn(protein))[0]

    protein, px_min = _timed("assembly system", assembly)
    pair = _timed("6 pair", phase_pair, protein, px_min)
    remd = _timed("7 protein remd", phase_protein_remd)

    cx = _timed("chignolin system", _chignolin)
    bias = _timed("8 bias", phase_bias, cx, system, x_min)
    fused = _timed("9 fused remd", phase_fused_remd, cx, bias["model"])
    cv = _timed("10 learned cv", phase_learned_cv, cx)

    periodic = _timed("11 periodic", phase_periodic)
    water = _timed("water box system", _water_box_system)
    cells = _timed("12 cells", phase_cells, periodic, water)
    explicit = _timed("13 explicit remd", phase_explicit_remd)
    water_md = _timed("14 water md", phase_water_md, water)
    del water

    large = _timed("15 large kernels", phase_large_kernels)
    bonded = _timed("16 bonded", phase_bonded, large)
    large_path = _timed("17 large path", phase_large_path)
    segment = _timed("18 production segment", phase_production_segment)
    pme_water = _timed("19 pme water", phase_pme_water)
    tip4pew = _timed("20 tip4pew segment", phase_tip4pew_segment)
    tip5p = _timed("21 tip5p box", phase_tip5p_box)
    analysis = _timed("22 analysis", phase_analysis_path, main_path)
    conformations = _timed("23 conformations", phase_conformations_path, cv, px_min)
    structure, chain_a = _timed("24 structure prep", phase_structure_prep)
    nucleic = _timed("25 nucleic complex", phase_nucleic_complex, chain_a)
    api_reports = _timed("26 api and reports", phase_api_reports, cv, cx)
    multi = _timed("27 multi-device", phase_multi_device)
    nblist = _timed("28 neighbor list", phase_neighbor_list, px_min)

    print(_card())
    R, N, Np = N_REPLICAS, system.n_atoms, protein.n_atoms
    Nc, M = cx["system"].n_atoms, len(cx["quads"])
    widths = bias["widths"]
    cuda = {"route": "cuda", "library_ms": None}
    fused_src = {**cuda, "source": "pmarlo_tpu_torch/csrc/fused_md.cu"}
    kernels = [{
        "name": "fused_md_chunk", **fused_src,
        "replaces": "pmarlo_tpu/md/pallas_md.py:791",
        "launches": (main_path["launches"] + cv["launches"]["fused_md_chunk"]
                     + nucleic["launches"] + api_reports["launches"]),
        "max_abs_err": kern["force_max_abs_err"],
        "ms": kern["chunk100_ms"],
        "plain_ms": kern["chunk100_plain_ms"],
        "timed": f"100 steps, R={R}, N={N}",
        **_md_bound(R, N, 101),
        "launch_shape": kern["chunk100_shape"],
        "ms_n138": bias["unbiased_chunk100_ms"],
        "bound_ms_n138": _md_bound(R, cx["system"].n_atoms, 101)["bound_ms"],
        "launch_shape_n138": bias["unbiased_chunk100_shape"],
    }]
    for name, line, err, tag in (
        ("pair_born", 465, "born_max_abs_err", "born"),
        ("pair_energy", 486, "dEdB_max_abs_err", "energy"),
        ("pair_force", 513, "force_max_abs_err", "force"),
    ):
        Rp = PROTEIN_REPLICAS
        flops, sfu = NEWTON_OPS[tag]
        pairs = Rp * Np * (Np - 1) / 2
        near = pair["born_near_directions"] if tag == "born" else 0
        kernels.append({
            "name": name, **cuda,
            "source": "pmarlo_tpu_torch/csrc/pair_force.cu",
            "replaces": f"pmarlo_tpu/md/pallas_pair.py:{line}",
            "launches": (remd["launches"][name] + structure["launches"][name]
                         + sum(r[name] for r in multi["protein_pair_launches_per_rank"])),
            "max_abs_err": pair[err],
            "ms": pair[f"{tag}_ms"],
            "plain_ms": pair[f"{tag}_plain_ms"],
            "timed": f"one sweep, R={Rp}, N={Np}",
            # positions, per-atom rows and Born radii in, one row a atom out
            **_bound(pairs * flops, pairs * sfu + near * BORN_NEAR_SFU, 4 * Rp * Np * 12),
        })
    shape = f"R={R}, N={Nc}"
    kernels += [{
        "name": "fused_md_bias_harmonic", **fused_src,
        "replaces": "pmarlo_tpu/md/pallas_md.py:436",
        "launches": cv["launches"]["bias_harmonic"],
        "max_abs_err": bias["harmonic_force_max_abs_err"],
        "ms": bias["harmonic_chunk100_ms"],
        "plain_ms": bias["harmonic_chunk100_plain_ms"],
        "timed": f"100 steps, {shape}",
        **_md_bound(R, Nc, 101, n_dih=M, widths=widths),
        "launch_shape": bias["harmonic_chunk100_shape"],
    }, {
        "name": "fused_md_bias_metadynamics", **fused_src,
        "replaces": "pmarlo_tpu/md/pallas_md.py:504",
        "launches": cv["launches"]["bias_metadynamics"],
        "max_abs_err": bias["metadynamics_force_max_abs_err"],
        "ms": bias["metadynamics_chunk100_ms"],
        "plain_ms": bias["metadynamics_chunk100_plain_ms"],
        "timed": f"100 steps, {shape}, {N_HILLS_CHECK} hills",
        **_md_bound(R, Nc, 101, n_dih=M, widths=widths, n_hills=N_HILLS_CHECK),
        "launch_shape": bias["metadynamics_chunk100_shape"],
    }, {
        "name": "fused_md_fused_metadynamics", **fused_src,
        "replaces": "pmarlo_tpu/md/pallas_md.py:1075",
        "launches": cv["launches"]["fused_metadynamics"],
        "max_abs_err": cv["ledger_centers_max_abs_err"],
        "ms": cv["fused_mtd_ms"],
        "plain_ms": cv["fused_mtd_plain_ms"],
        "timed": f"{cv['timed_steps']} steps, 2 deposit windows, {shape}, "
                 f"{cv['mtd_hills']} hills",
        **_md_bound(R, Nc, cv["timed_steps"] + 1, n_dih=M, widths=widths,
                    n_hills=cv["mtd_hills"]),
        "launch_shape": cv["fused_mtd_shape"],
    }, {
        "name": "fused_remd", **fused_src,
        "replaces": "pmarlo_tpu/md/pallas_md.py:1298",
        "launches": cv["launches"]["fused_remd"],
        "max_abs_err": max(fused["unbiased_vs_plain_frames_max_dx_nm"],
                           fused["biased_vs_plain_frames_max_dx_nm"]),
        "ms": fused["fused_remd_ms"],
        "plain_ms": fused["fused_remd_plain_ms"],
        "timed": f"{fused['timed_steps']} steps, 2 windows, unbiased, {shape}",
        **_md_bound(R, Nc, fused["timed_steps"] + fused["timed_steps"] // CV_REPORT,
                    frames=fused["timed_steps"] // CV_REPORT),
        "launch_shape": fused["fused_remd_shape"],
        "device_ms": fused["fused_remd_device_ms"],
    }]
    Re, Ne, Nw = EXPLICIT_REPLICAS, periodic["atoms"], cells["water_atoms"]
    kernels += [{
        "name": "periodic_force", **cuda,
        "source": "pmarlo_tpu_torch/csrc/periodic_force.cu",
        "replaces": "pmarlo_tpu/md/pallas_periodic.py:190",
        "launches": explicit["dense"]["launches"]["periodic_force"] + tip5p["launches"],
        "max_abs_err": periodic["shifted_force_max_abs_err"],
        "ms": periodic["sweep_ms"],
        "plain_ms": periodic["sweep_plain_ms"],
        "timed": f"one sweep, R={Re}, N={Ne}",
        "bound_ms": periodic["bound_ms"], "bound_by": periodic["bound_by"],
        "bound_share": periodic["bound_share"],
    }, {
        "name": "cell_force", **cuda,
        "source": "pmarlo_tpu_torch/csrc/cell_force.cu",
        "replaces": "pmarlo_tpu/md/pallas_cells.py:232",
        "launches": (explicit["cells"]["launches"]["cell_force"] + water_md["launches"]
                     + segment["launches"] + pme_water["launches"] + tip4pew["launches"]),
        "max_abs_err": cells["water_r1_force_max_abs_err"],
        "ms": cells["water_r1_sweep_ms"],
        "plain_ms": cells["water_r1_sweep_plain_ms"],
        "timed": f"one sweep, R=1, N={Nw}",
        "bound_ms": cells["water_r1_bound_ms"], "bound_by": cells["water_r1_bound_by"],
        "bound_share": cells["water_r1_bound_share"],
        "ms_r4": cells["water_r4_sweep_ms"], "bound_ms_r4": cells["water_r4_bound_ms"],
        "ms_chignolin_r8": cells["chignolin_sweep_ms"],
        "bound_ms_chignolin_r8": cells["chignolin_bound_ms"],
    }]
    kernels.append({
        "name": "cell_force_slab", **cuda,
        "source": "pmarlo_tpu_torch/csrc/cell_force.cu",
        "replaces": "pmarlo_tpu/md/pallas_cells.py:232",
        "mesh_branch": "pmarlo_tpu/md/pallas_cells.py:428-560",
        "launches": multi["slab_launches"],
        "max_abs_err": multi["slab_max_abs_err"],
        "ms": multi["slab_ms"],
        "plain_ms": multi["slab_plain_ms"],
        "timed": f"one x-slab sweep of rank 0 of {MD_RANKS} (timed while the other waits), R=1, "
                 f"N={multi['rank0']['water_atoms']}, "
                 f"{multi['rank0']['rf_slab_atoms']} atoms in the slab",
        **multi["slab_bound"],
        "unsharded_ms_same_call": multi["rank0"]["rf_unsharded_ms"],
    })
    Nl = large_path["atoms"]
    for mode, lines, path_counts in (
        ("culled", (984, 1009, 1039), large_path["ordered_launches"]),
        ("newton", (1442, 1461, 1479), large_path["launches"]),
    ):
        for (tag, err), line in zip((("born", "born_max_abs_err"),
                                     ("energy", "dEdB_max_abs_err"),
                                     ("force", "force_max_abs_err")), lines):
            name = f"pair_{tag}_{mode}"
            alone = ({"graph_ms": large_path[f"culled_{tag}_graph_ms"]}
                     if mode == "culled" else {})
            kernels.append({
                "name": name, **cuda,
                "source": ("pmarlo_tpu_torch/csrc/pair_newton.cu" if mode == "newton"
                           else "pmarlo_tpu_torch/csrc/pair_force.cu"),
                "replaces": f"pmarlo_tpu/md/pallas_pair.py:{line}",
                "launches": path_counts[name] + nblist["launches"].get(name, 0),
                "max_abs_err": large_path[f"{mode}_{err}"],
                "ms": large_path[f"{mode}_{tag}_ms"],
                "plain_ms": large_path[f"{mode}_{tag}_plain_ms"],
                "timed": f"one sweep, R=1, N={Nl}, cutoff {GB_CUTOFF} nm, tile {LARGE_TILE}",
                "bound_ms": large_path[f"{mode}_{tag}_bound_ms"],
                "bound_by": large_path[f"{mode}_{tag}_bound_by"],
                **alone,
            })
    kernels.append({
        "name": "bonded", **cuda,
        "source": "pmarlo_tpu_torch/csrc/bonded.cu",
        "replaces": "pmarlo_tpu/md/bonded_window.py:350",
        "launches": (large_path["launches"]["bonded"] + large_path["ordered_launches"]["bonded"]
                     + nblist["launches"]["bonded"]),
        "max_abs_err": large_path["bonded_grad_max_abs_err"],
        "ms": large_path["bonded_ms"],
        "graph_ms": large_path["bonded_graph_ms"],
        "plain_ms": large_path["bonded_plain_ms"],
        "timed": f"a call (graph_ms: the kernel alone, a CUDA graph of 50 calls), R=1, "
                 f"N={Nl}, hydrogen bonds stripped",
        "bound_ms": large_path["bonded_bound_ms"], "bound_by": large_path["bonded_bound_by"],
    })
    # the headline numbers again, close to the end of the output
    _line("summary", {
        "build_s": build["build_s"],
        "fused_ptxas": build["fused_ptxas"],
        "pair_ptxas": build["pair_ptxas"],
        "periodic_ptxas": build["periodic_ptxas"],
        "periodic": {k: periodic[k] for k in (
            "sweep_ms", "bound_ms", "bound_share", "periodic_two_launches_bitwise_equal",
            "walk_patches", "walk_pairs_queued", "walk_pairs_a_batch", "eval_ms",
            "shifted_sweep_force_rel_err", "shifted_vs_oracle_force_rel_err")},
        "cells": {k: cells[k] for k in (
            "water_r1_sweep_ms", "water_r1_bound_share", "water_r4_sweep_ms",
            "water_r4_bound_share", "chignolin_sweep_ms", "chignolin_bound_share",
            "water_r1_cell_two_launches_bitwise_equal",
            "water_r4_cell_two_launches_bitwise_equal",
            "chignolin_cell_two_launches_bitwise_equal", "water_r1_walk_pairs_a_batch",
            "chignolin_walk_pairs_a_batch", "water_r1_eval_ms",
            "rf_vs_periodic_kernel_force_rel_err")},
        "explicit_ms_per_step": {k: explicit[k]["ms_per_step"] for k in ("dense", "cells")},
        "water_md": {k: water_md[k] for k in (
            "ms_per_step", "nve_drift_kT_per_dof_per_ns", "launches")},
        "pair": {k: pair[k] for k in (
            "born_rel_err", "e_rows_rel_err", "total_energy_rel_err", "energy_vs_float64",
            "force_rel_err", "force_vs_float64", "born_two_launches_bitwise_equal",
            "energy_two_launches_bitwise_equal", "force_two_launches_bitwise_equal",
            "born_ms", "energy_ms", "force_ms", "newton_force_ms", "newton_born_ms",
            "newton_energy_ms", "eval_ms")},
        "fused": {
            "chunk100_ms": kern["chunk100_ms"], "chunk100_n138_ms": bias["unbiased_chunk100_ms"],
            "harmonic_chunk100_ms": bias["harmonic_chunk100_ms"],
            "metadynamics_chunk100_ms": bias["metadynamics_chunk100_ms"],
            "fused_mtd_ms": cv["fused_mtd_ms"], "fused_remd_ms": fused["fused_remd_ms"],
            "fused_remd_device_ms": fused["fused_remd_device_ms"],
            "fused_ptxas": build["fused_ptxas"],
            "alanine_ns_per_day": times["kernel_ns_per_day_aggregate"],
            "sweep_n22": kern["replica_sweep"], "sweep_n138": bias["replica_sweep"],
            "learned_cv_walls_s": {k: cv[k] for k in (
                "remd_wall_s", "train_s", "biased_windows_wall_s", "biased_fused_wall_s",
                "mtd_wall_s")},
        },
        "large_kernels": {k: large[k] for k in (
            "atoms", "tile_block_share", "pairs_within_share_of_visited", "newton_walk",
            "newton_born_ms", "newton_energy_ms", "newton_force_ms", "tile_table_ms",
            "newton_patch_list_ms", "newton_r1_total_energy_rel_err",
            "newton_r1_born_kernel_total_energy_rel_err",
            "culled_eval_ms", "newton_eval_ms", "dense_eval_ms", "dense_born_ms",
            "dense_energy_ms", "dense_force_ms")},
        "bonded": {k: bonded[k] for k in ("atoms", "incidences", "bonded_graph_ms", "bonded_ms",
                                          "bonded_plain_ms", "bound_ms",
                                          "r1_two_launches_bitwise_equal")},
        "large_path": {k: large_path[k] for k in (
            "atoms", "system_build_s", "force_fn_build_s", "minimize_s", "tile_block_share",
            "ms_per_step", "ns_per_day", "eval_ms", "ordered_ms_per_step", "ordered_eval_ms",
            "newton_born_ms", "newton_energy_ms", "newton_force_ms", "culled_born_ms",
            "culled_born_graph_ms", "culled_born_bound_ms",
            "culled_born_two_launches_bitwise_equal", "culled_energy_ms",
            "culled_energy_graph_ms", "culled_energy_bound_ms",
            "culled_energy_two_launches_bitwise_equal", "culled_force_ms",
            "culled_force_graph_ms", "culled_walk_host_replay", "culled_force_bound_ms",
            "culled_force_two_launches_bitwise_equal", "bonded_graph_ms", "bonded_ms",
            "bonded_bound_ms", "bonded_two_launches_bitwise_equal",
            "newton_force_bound_ms", "newton_born_bound_ms", "newton_energy_bound_ms",
            "newton_patch_list_ms",
            "reported_kinetic_over_target_second_half", "kinetic_over_target_state_by_ps",
            "max_constraint_deviation_nm", "peak_device_memory_gib",
            "peak_device_memory_with_plain_gib", "tile_table_ms", "launches")},
        "production_segment": {k: segment[k] for k in (
            "ms_per_step", "ns_per_day", "step_eval_ms", "segment_wall_s", "resume_wall_s",
            "segment_setup_minimize_s", "segment_acceptance",
            "segment_kinetic_over_target_second_half", "max_constraint_deviation_nm",
            "final_kernel_vs_oracle_energy_rel_err", "final_kernel_vs_oracle_force_rel_err",
            "launches")},
        "pme_water": {k: pme_water[k] for k in (
            "ms_per_step", "npt_acceptance", "peak_device_memory_gib", "eval_ms", "sweep_ms",
            "binning_ms", "band_correction_ms", "spread_ms", "fft_ms", "gather_ms",
            "run_to_run_force_rel", "squeezed_move_host_syncs", "launches")},
        "tip4pew_segment": {k: tip4pew[k] for k in (
            "atoms", "sites", "ms_per_step", "ns_per_day", "step_eval_ms", "expand_ms",
            "spread_ms", "site_share_of_step", "segment_acceptance",
            "kinetic_over_target_second_half", "max_constraint_deviation_nm",
            "sites_max_off_parents_nm", "final_kernel_vs_oracle_energy_rel_err",
            "final_kernel_vs_oracle_force_rel_err", "rdf_peak_nm", "rdf_peak_height",
            "oxygen_diffusion_cm2_s", "launches")},
        "tip5p_box": {k: tip5p[k] for k in (
            "atoms", "sites", "ms_per_step", "nve_drift_kT_per_dof_per_ns",
            "sites_max_off_parents_nm", "end_kernel_vs_plain_force_rel_err", "eval_ms",
            "sweep_ms", "launches")},
        "analysis_path": {k: analysis[k] for k in (
            "walls_s", "tica_eigenvalues", "msm_active_states", "selected_lag", "ck_rms",
            "macrostate_sizes", "reversible_flow_asymmetry")},
        "conformations_path": {k: conformations[k] for k in (
            "walls_s", "frames", "features_ms", "features_peak_gib", "sasa_per_atom_ms",
            "assembly_sasa_ms", "assembly_sasa_cpu_s", "assembly_sasa_peak_gib",
            "assembly_atoms_buried_by_other_copies", "dssp_native_helix_strand_coil",
            "dssp_run_helix_strand_coil", "enhanced_active_states", "committor_sum_off_1",
            "net_flux_conservation_max")},
        "structure_prep": {
            "phase_s": structure["phase_s"], "stage_timer": structure["stage_timer"],
            "properties": structure["properties"], "rebuilt_bonds": structure["rebuilt_bonds"],
            "closure_rmsd_nm": structure["closure_rmsd_nm"],
            "rows_prepared": {k: structure["rows"]["prepared"][k] for k in (
                "born_rel_err", "e_rows_rel_err", "force_rel_err", "total_energy_rel_err")},
            "rows_minimized": {k: structure["rows"]["minimized"][k] for k in (
                "born_rel_err", "e_rows_rel_err", "force_rel_err", "total_energy_rel_err")},
            "remd": structure["remd"], "remd_wall_s": structure["remd_wall_s"],
            "remd_ms_per_step_with_setup": structure["remd_ms_per_step_with_setup"],
            "segment": structure["segment"], "launches": structure["launches"],
            "pipeline_replayed": structure["pipeline_replayed"]},
        "nucleic_complex": {
            "phase_s": nucleic["phase_s"],
            **{kind: {k: nucleic[kind][k] for k in (
                "atoms", "strand_charge", "force_rel_err", "chunk_max_dx_nm",
                "chunk_energy_rel_err", "launches", "run_wall_s", "mean_acceptance",
                "kinetic_over_target", "kinetic_over_target_per_rung")}
               for kind in ("dna", "rna")}},
        "api_reports": {k: api_reports[k] for k in (
            "walls_s", "matplotlib", "steps_not_run", "launches",
            "row1_vs_plain", "system_fields_differing", "mean_acceptance",
            "kinetic_over_target", "align_max_err_nm", "msm_active_states",
            "fes_finite_fraction", "conformations", "benchmark")},
        "multi_device": {
            "backend": multi["backend"], "ranks": multi["world"],
            "alanine_frames_max_abs_dx_nm": [multi[f"alanine_rank{r}"]["frames_max_abs_dx_nm"]
                                             for r in range(MD_RANKS)],
            "protein_frames_max_abs_dx_nm": [multi[f"protein_rank{r}"]["frames_max_abs_dx_nm"]
                                             for r in range(MD_RANKS)],
            "slab_launches": multi["slab_launches"], "slab_ms": multi["slab_ms"],
            "slab_plain_ms": multi["slab_plain_ms"],
            "unsharded_ms": multi["rank0"]["rf_unsharded_ms"],
            "scratch_bytes": multi["rank0"]["rf_scratch_bytes"],
            "unsharded_scratch_bytes": multi["rank0"]["rf_unsharded_scratch_bytes"],
            "walls_s": multi["walls_s"]},
        "neighbor_list": {k: nblist[k] for k in (
            "atoms", "card", "min_parity_capacity_default", "min_parity_n_max",
            "min_max_force", "min_nblist64_vs_float64_force_rel_err",
            "min_nblist_vs_float64_force_rel_err", "min_newton_vs_float64_force_rel_err",
            "min_nblist_vs_newton_energy_rel_err", "warm_max_force",
            "warm_nblist_vs_newton_energy_rel_err", "warm_nblist_vs_newton_force_rel_err",
            "warm_nblist_vs_ordered_energy_rel_err", "warm_nblist_vs_ordered_force_rel_err",
            "warm_nblist_eval_ms", "newton_eval_ms", "md_capacity", "md_list_n_max_start",
            "md_list_n_max_end", "list_build_ms", "nblist_ms_per_step", "row7_ms_per_step",
            "nblist_peak_device_memory_gib", "row7_peak_device_memory_gib",
            "nblist_state_kinetic_over_target_last_200_steps", "rolled_bonded_force_rel_err",
            "shake_rolled_vs_indexed_max_dx_nm", "rolled_constrained_ms_per_step",
            "indexed_constrained_ms_per_step", "rolled_max_constraint_deviation_nm",
            "launches", "walls_s")},
        "phase_s": PHASE_S,
        "script_s": time.perf_counter() - t_start,
    })
    _line("before the redesign (one-thread-an-atom fused kernels, row-owned dense "
          "Born and energy sweeps, the Newton Born and energy block walk, row-owned "
          "periodic and cell sweeps, the one-pass bonded kernel and the row-owned culled "
          "sweeps), ms at the same timed shapes, copied from PERF.md, not measured here",
          EARLIER_MS)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
