#!/usr/bin/env python3
"""End-to-end proof that the PyTorch/CUDA port runs on one NVIDIA H100.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py

It drives only the port (`dm_control_tpu_torch`), never JAX, in phases;
any failure exits non-zero and no phase catches its own failure:

  1. build: compiles every kernel under dm_control_tpu_torch/csrc/ with
     nvcc for sm_90a (one nvcc per source, all started together);
  2. kernels: holds each kernel against its plain PyTorch version on the
     card at float32: K1a/b/c (batched Cholesky factor, fused solve,
     substitution) at finger's (4096, 3, 3), walker's (4096, 9, 9), at
     n = 27, 56, 96 (MAX_N) and at the slices' n = 1 (pendulum), 2
     (reacher, cartpole, acrobot, point_mass), 7 (hopper), 4
     (ball_in_cup), 8 (swimmer6) and 13 (fish), bound 1e-4 scaled by
     max(1, |ref|); for each
     also the launch configuration (lanes per environment), the first
     4093 lanes alone and a second launch giving the full batch's bits,
     K1c on K1a's L giving K1b's bits, K1a's L contiguous, exactly 0 above
     the diagonal and unchanged when A's upper triangle is NaN, and K1c's
     x unchanged when L's is; K2 (Newton solve) on walker's solver inputs
     at batch 4096 made by the port, against the plain float32 solve and
     the plain float64 optimum: mean <= 1e-4, max <= 5e-2 and <= 10% of
     lanes above 1e-3 (tests/test_pallas.py), each error scaled by
     max(1, the lane's largest |ref|);
     K2-ell (the Newton solve's elliptic-cone branch) on finger-spin
     solver inputs at batch 4096 rich in contacts (joint angles drawn by
     the port's randomizer, kept where they touch, random velocities so
     that contacts slide), with the same bounds against plain float32
     and float64, converged and after one Newton iteration (which
     depends on the Hessian's and the line search's cone terms); for
     both, the launch configuration (one warp per environment), and the
     first 4093 lanes alone (no multiple of the warps per block) and a
     second launch must give the full batch's bits; K2 likewise on
     cheetah's first impacts (nefc 222, nv 9), on carts at cartpole's
     slider limit (nefc 1, nv 2), on point masses at a wall (nefc 2, nv
     2), on ball_in_cup's balls in the cup, on the floor or at the end of
     the string (nefc 65, nv 4), on swimmers at a joint limit (nefc 5,
     nv 8), on humanoids lying on the floor (nefc 136, nv 27) and on
     quadrupeds standing or fallen (nefc 230, nv 22), every top-K group
     of humanoid and quadruped's floor group selecting a live pair on
     some lane (`topk_live`); for those two also the top-K broadphase
     (`broadphase_bits`): the selection and every contact field it
     gathers for the first 4093 lanes alone, and for a second call, equal
     the full batch's bit for bit; K2-ell at the six manipulator and
     stacker layouts (nefc 392-1166, nv 11-20, 128-386 cones; stack_4 one
     environment per block) on states with the props on the floor,
     stacked or in the slot (`prop_states`), held by `ell_gates` with the
     same launch and bit checks; K2 at the tenth slice's layouts with
     the same bounds, launch and bit checks and the top-K checks:
     humanoid_CMU lying on or pressed into the floor (nefc 880, nv 62:
     the two-dofs-per-lane family, J read from device memory), escape's
     quadrupeds on their terrains (nefc 378, nv 22) and fetch's with the
     ball against the floor and a wall (nefc 598, nv 28), converged and
     after one Newton iteration (`float32_gates`: plain float32 itself
     misses K2's bounds there at humanoid_CMU's layout); K2 raising at
     nv 85 on the card without a launch; and K1 at humanoid's n = 27,
     quadruped's n = 22, manipulator's n = 11, stacker's 14 and 20,
     humanoid_CMU's 62 and fetch's 28 on their initial states (drawn
     collision-free, humanoid's and the quadrupeds' settled), with the
     same bound and bit checks; the eleventh slice's: K2-ell's C = 6
     instantiation (elliptic cones of condim 3, 4 and 6 in one layout) at
     the cone model's layouts (`cones_xml`: one copy nv 18, nefc 48, two
     nv 36, nefc 180) on `cone_states` where every condim's cones are
     live, converged (`stop_gates`: the condim-6 ball's rolling rows leave
     the cost flat to float32 along a direction on some lanes, where any
     float32 solve may stop far from float64; a kernel lane over K2's
     line must have stopped within BAND * EPS32 * scale of the optimum's
     cost, and `ell_gates` holds the other lanes) and after one Newton
     iteration (`float32_gates`), with the launch and bit checks; K2 at
     jaco's (4096, 145, 13) with the target sphere on a link and the
     fingers at their limits (`jaco_states`), the top-K checks included;
     K1 at jaco's n = 13, lqr_6_2's 6 and the cone model's 18 and 36; the
     twelfth slice's: the route past the Newton kernel's 64 dofs (the core,
     `newton_kernel.newton_solve_core`, with K1b as each iteration's
     factor-and-solve: the JAX package's own route there) at dog-stand's
     (4096, 1912, 79) and dog-fetch's (4096, 3822, 85), dogs standing or
     lying, fetch's ball beside the head, in the mouth or on the target
     (`dog_states`): K1b launched exactly once per iteration of the loop
     the core reports, held converged by `stop_gates` and after one Newton
     iteration by `float32_gates` against the plain float32 core and the
     float64 one (`core_task_check`), the top-K selection bit for bit; and
     K1 at dog's n = 79 and 85 on its initial states;
  3. reference: one control step of REF_LANES = 256 walker-walk lanes,
     and of 256 finger-spin lanes in contact, on the card at float32
     against the port's float64 path from the same state, run on the
     card through the plain versions of every kernel (`plain_kernels`),
     every run recording its discrete choices at every acc stage
     (contact activity and normals, limit activity, the solve's warmstart
     choice and its rows' and cones' zones, and tendon limits where the
     model has them; the box colliders' corner and axis choices,
     `box_choices`; the heightfield cell under each heightfield contact,
     `hfield_cells`; the mesh colliders' switches, `mesh_choices`, from
     what the colliders computed): each lane within REF_TOL =
     1e-2 (max scaled error of qpos and qvel) is held; one over it is
     excused where its first differing choice stood within BAND * EPS32 *
     scale of its threshold in the float64 run, or, with every choice
     matched, where each of its float32 Newton solves stopped within BAND
     * EPS32 * scale of the cost of the float64 optimum of its own inputs
     (`solve stop`) and its error is within STOP_TOL = 5e-2, and fails
     otherwise (a lane that fails is judged again against the float64
     path run on the CPU for such lanes alone, `cpu_reference`: the
     card's plain float64 Newton solve can depend on the batch); the
     kernels' run may excuse at most twice the lanes that the same step
     with K1 as plain PyTorch excuses, plus one;
  4. rollout: BatchedEnv(walker-walk, batch_size=4096) on the card, three
     runs of reset and 20 control steps (200 physics substeps) through
     `rollout_fn`; then
     BatchedEnv(finger-spin, 4096), three runs of reset and 20 control
     steps (40 substeps): every state finite, rewards in [0, 1], each
     kernel's launch count exactly its expected count per control step;
     then finger-spin with an episode limit of 3 control steps, which
     sends every lane through the reset pool; then the cone model: 4096
     lanes dropped from 2 to 20 cm, CONES_STEPS = 200 physics steps,
     states finite, one K2-ell launch per physics step, live cones of
     every condim at the end, and phase 3's gate on 256 of its lanes;
  5. timing (before phase 6): each kernel and its plain version with
     CUDA events at the main path's shapes, and, for K1, the one
     torch.linalg call that
     computes the same function (`library_ms`, never used by the port);
     the Newton rows carry the largest iteration count of their inputs
     (`max_iters`), which sets a launch's time.  K1 rows are at walker's
     (4096, 9, 9) with finger's (4096, 3, 3) beside them (`finger`), and
     add `kernel_ms` (CUDA events around 50 back-to-back launches of the
     ctypes entry on pre-made buffers, no wrapper work between them),
     `device_ms` and `kernels_per_call` (the CUDA kernels of one wrapper
     call and their device time, from one torch.profiler session over
     every such call; each must launch exactly one), and the launch
     configuration; then walker's K1 time per
     control step, 11 K1a + 10 K1b + 10 K1c.  K1 rows also carry the
     slices' n = 1, 2, 7, 4, 8 and 13 on pendulum's, reacher's, hopper's,
     ball_in_cup's, swimmer6's, fish's, humanoid's (27) and quadruped's
     (22) initial states (`pendulum`, `reacher`, `hopper`, `ball_in_cup`,
     `swimmer`, `fish`, `humanoid`, `quadruped`), and the K2 row the
     first impacts or limits of cheetah, cartpole, point_mass,
     ball_in_cup, swimmer6, humanoid and quadruped (keyed by domain, with
     K2's device time under torch.profiler, one CUDA kernel per call),
     each with the launches of its task's run in phase 6;
  6. slice (after phase 5, whose profiler sessions lost every event when
     they ran after it): BatchedEnv(task, 4096) of each of SLICE_TASKS
     (cheetah-run, hopper-hop, pendulum-swingup, reacher-easy,
     cartpole-swingup, acrobot-swingup (both RK4), finger-turn_easy,
     point_mass-easy, ball_in_cup-catch, swimmer-swimmer6, fish-swim,
     humanoid-run, quadruped-walk, SLICE9_TASKS: manipulator
     bring_ball, bring_peg, insert_ball and insert_peg, SLICE10_TASKS:
     humanoid_CMU-run, quadruped-escape and quadruped-fetch, and
     SLICE11_TASKS: lqr-lqr_6_2 and jaco-position_reacher_7DOF, and
     SLICE12_TASKS: dog stand, walk, trot, run and fetch; stacker is held
     in phase 2 only, STACKER_TASKS), one run each (run SLICE_RUN) of
     reset and `slice_steps` control steps: states (model_var and act
     included) finite, rewards in each task's range (`REWARD_RANGE`: jaco's fence and action penalties go
     below 0, lqr's reward has no lower bound; [0, 1] for the others),
     every kernel's launch count exactly `expected_launches` per control
     step, plus, for dog, K1b once per iteration of the core's loops (the
     count the core reports) and one core call per physics step; then
     (but for UNGATED_TASKS, dog's five, whose float32 steps miss float64
     past the gate's rule on some lanes as the JAX package's and the
     port's CPU float32 steps do: `tools/float32_step_probe.py`)
     phase 3's gate on 256 lanes of each task's
     final states (act compared too where the model has activations, and
     under the top-K broadphase, or for plane-box pairs, the contacts
     keyed by pair or box corner, with the selection and the box
     colliders' choices recorded: `branches`; jaco's controls its
     actions made by `before_step`, and its gate over 25 of the control
     step's 100 physics steps, `GATE_SUBSTEPS`), and escape's rangefinder
     observation held per lane to the float64 CPU path's from the same
     state (`rangefinder_check`); then reacher-easy, finger-turn_easy,
     cheetah-run, ball_in_cup-catch, swimmer-swimmer6, fish-swim,
     humanoid-run, quadruped-walk, manipulator-insert_peg and the tenth
     slice's three tasks with an episode limit that ends every lane's
     episode: reacher's, swimmer's and fish's lanes hold the target
     geom_pos their fresh init drew, the others their reset pool entry
     (finger-turn's target site_pos, quadruped's act, insert_peg's
     body_pos and body_quat, escape's hfield_data included);
  7. train (after phase slice; generators of its own, TRAIN_SEED): K1's
     autograd Functions (`_src/linalg.py`) at (4096, n), n = 9, 27 and 62,
     forward and backward through the kernels' forward, each output and
     cotangent held by `ell_gates` against the same Functions with the
     plain forward at float32 and at float64 (`k1_autograd`); lqr_2_1 and
     lqr_6_2: `lqr_solver.linearize` through the kernels (float32; K1a and
     K1c launched exactly once per pipeline, none in the backward) and
     through the plain versions (float64), A, B and K held against
     float64, then LQR_LANES = 256 lanes regulated under u = -K x for
     LQR_STEPS control steps, each one replay of a CUDA graph of
     `forward.step` (its K1 launches recorded at capture): every lane's
     |(qpos, qvel)| under 1e-2 and reward over 0.999 at the end
     (`lqr_phase`); SAC: `make_sac_trainer('cheetah', 'run', 4096)` with
     the default SACConfig (hidden 256 x 256, learn batch 256, replay
     2^17), TRAIN_STEPS = 20 train steps, each kernel's launches exactly
     20 x `expected_launches` (no lane resets), metrics finite, the actor
     moved, then one update on the card against the same update at
     float64 on the CPU (the state through `bridge`, the same batch and
     normal draws): gradients within SAC_GRAD_TOL of each tensor's largest
     entry, updated parameters within SAC_PARAM_TOL x lr (`sac_phase`).
     `python3 chip_smoke.py --train-only` runs the build and this phase
     alone, without the contract's last line;
  8. composer (after phase train; generators of its own, COMPOSER_SEED):
     the composer's BatchedEnvironment at 4096 lanes over the locomotion
     tasks (`COMPOSER_TASKS`: go_to_target with the Ant, the CMU humanoid
     and the jumping ball, run_through_corridor, random_goal_maze and
     escape with the Ant, two_touch with the rodent), one forward.step per
     physics substep and the observation pipeline after it, a reset and 5
     control steps each (CMU 3, rodent 2): states finite, every
     observation of its spec's shape and finite, rewards in each task's
     range (`COMPOSER_REWARD_VALUES`: the indicators' 0 or 1, two_touch's
     pulses 0, 0.2 or 1), no auto-reset, every kernel's launches exactly
     `composer_launches` per control step and, for the rodent, the core's
     calls `composer_core_calls` with K1b once per iteration of its loops;
     K1 at n = 14 (the Ant), 8 (the ball) and 73 (the rodent) on their
     initial mass matrices (`composer_k1`: `ell_gates` and the bit checks),
     K2 at the Ant's (4096, 284, 14), the corridor's (4096, 420, 14), the
     maze's (4096, 572, 14), the CMU's (4096, 768, 62) and the ball's
     (4096, 81, 8) layouts and the core at the rodent's (4096, 1561, 73)
     on the step's states with the most lanes in contact
     (`k2_task_check`, `core_task_check`); phase 3's gate on 256 lanes of
     each task's final states but COMPOSER_UNGATED's; then go_to_target
     (Ant) and two_touch with episode limits that end every lane's episode
     at the last control step: each lane's state, model_var (two_touch's
     latch, colours and machine state included) and buffers its fresh
     draw, its substep counter 1, and a forward's launches more.
     `python3 chip_smoke.py --composer-only` runs the build and this phase
     alone, without the contract's last line;
  9. manipulation (after phase composer; generators of its own,
     MANIPULATION_SEED): the manipulation tier's BatchedEnvironment at 4096
     lanes over `MANIPULATION_TASKS` (place_cradle, nv 19; stack_2_bricks,
     nv 25, the brick pin and goal hints; reassemble_5_bricks, nv 43, K2's
     two-dofs-per-lane family), RK4 at 1 ms, 40 physics steps per control
     step, position targets within 0.1 rad of the arm's angles: a reset and
     one control step at an episode limit of one control step, so that the
     step also resets every lane: the stepped states (kept by an after_step
     hook of the phase's) finite and not diverged, rewards in [0, 1],
     launches exactly `composer_launches` plus a forward's
     (`reset_launches`), each lane's state, model_var (site_pos, body_pos,
     body_quat, duplo_pin, duplo_pin_qpos, the int32 duplo_order) and
     buffers its fresh draw, every observation of its spec's shape and
     finite; K1 at n = 19, 25 and 43 on the initial mass matrices
     (`composer_k1`) and K2 at the three layouts on the stepped states
     (`k2_task_check` with `stop_gates`: the kernel's and plain float32's
     solves stop far from float64 on many lanes where the cost is flat to
     float32); the tasks of MANIPULATION_UNGATED, whose float32 steps miss
     float64 past the gate's rule as the JAX package's do, write their
     256 gated lanes to chiprun_out/ for `tools/reference_step_cpu.py`
     instead of the reference gate.  `python3 chip_smoke.py
     --manipulation-only` runs the build and this phase alone, without the
     contract's last line.

Output: the card's name and power limit (nvidia-smi), env-steps/s of
walker-walk@4096 and finger-spin@4096 (each the median of three runs)
and each slice task@4096 (its one run; the K2-ell row
carries its time at each ninth-slice layout and at the cone model's two
('cones x1', 'cones x2'), the K1 rows at n = 11, 14, 20, 62, 28, 13, 6,
18, 36, 79 and 85, the K1b row also the core's route at dog's two
layouts ('core': ms per call of the whole route, its K1b launches per
call and in the slice run, its bound), the K2 row at the tenth slice's
three layouts and jaco's, keyed by task; the K1 rows' 'autograd' (ms per
forward, per forward + backward, the plain and the torch.linalg forward
+ backward, at n = 9, 27, 62) and 'lqr' (launches of each linearize and
rollout), and the train path's launches ('train': K1a/b/c and K2 in the
20 SAC train steps), and the composer's entries at its tasks' shapes, keyed
by task: K1 at n = 14, 8 and 73, K2 at the Ant's, corridor's, maze's,
CMU's and ball's layouts, the core at the rodent's under the K1b row's 'core'), the train
phase's lqr and SAC numbers (env-steps/s, updates/s, the update's share),
env-steps/s of each composer task@4096 (its one run) and of each
manipulation task@4096 (one control step with every lane's reset; the K1
rows and the K2 row carry entries at its shapes, keyed by task), one
`{"kernels": [...]}` JSON line, and last the
`{"ok": true, "device": {...}}` line.  The nvcc/ptxas log of the build
is in dm_control_tpu_torch/_build/build.log; its register and spill lines
are printed.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

BATCH = 4096
CONTROL_STEPS = 20
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
FINGER_RUNS = 3
WALKER_RUNS = 3
# the ninth slice's tasks (the box colliders; K2-ell at manipulation-sized
# layouts), their kernel-phase generator's seed, the tasks whose initial
# states give K1's n = 11, 14 and 20, and the control steps of each of
# their runs in phase slice
SLICE9_TASKS = ('manipulator-bring_ball', 'manipulator-bring_peg',
                'manipulator-insert_ball', 'manipulator-insert_peg')
SLICE9_SEED = 40
SLICE9_K1 = ('manipulator-bring_ball', 'stacker-stack_2', 'stacker-stack_4')
SLICE9_STEPS = 6
# stacker's tasks, held in phase kernels only (K2-ell at their layouts, K1
# at n = 14 and 20): their float32 step misses the float64 path past the
# reference gate's rule on some lanes, as the JAX package's float32 step
# does (PERF.md, ROADMAP queue 3), so they are not in phase slice
STACKER_TASKS = ('stacker-stack_2', 'stacker-stack_4')
# the tenth slice's tasks (K2 past 32 dofs: humanoid_CMU's nv 62; the
# heightfield and the rangefinder: escape; the condim-6 ball and the walls:
# fetch), their kernel-phase generator's seed, the tasks whose initial
# states give K1's n = 62 and 28, and the control steps of each run
SLICE10_TASKS = ('humanoid_CMU-run', 'quadruped-escape', 'quadruped-fetch')
SLICE10_SEED = 50
SLICE10_K1 = ('humanoid_CMU-run', 'quadruped-fetch')
SLICE10_STEPS = 10
# the eleventh slice's cone model: free bodies under cone="elliptic" with
# the soccer pitch's and ball's condims and frictions
# (dm_control_tpu/locomotion/soccer.py:75,113): a condim-6 ball, a condim-4
# box and a condim-3 capsule on a condim-3 floor, which give K2-ell's
# condim-6, -4 and -3 cones in one layout (`cones_xml`); its generator's
# seed, and the physics steps of its 4096-lane run
CONES_XML = """<mujoco model="cones">
  <option cone="elliptic" timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 .1" condim="3" friction=".5 .02 .02"/>
    <body name="ball" pos="0 0 .11"><freejoint/>
      <geom name="ball" type="sphere" size=".117" mass=".45" condim="6" friction=".7 .005 .0001"/></body>
    <body name="box" pos=".3 0 .05"><freejoint/>
      <geom name="box" type="box" size=".05 .05 .05" condim="4" friction=".5 .02 .02"/></body>
    <body name="rod" pos="-.3 0 .03"><freejoint/>
      <geom name="rod" type="capsule" size=".03 .1" euler="0 90 0" condim="3"/></body>
  </worldbody>
</mujoco>"""
SLICE11_SEED = 60
CONES_STEPS = 200
# the eleventh slice's tasks through BatchedEnv (jaco's other two tasks
# differ from position_reacher_7DOF only in before_step, held on the CPU),
# the control steps of each run (jaco: 100 RK4 physics steps per control
# step), and each task's reward range
SLICE11_TASKS = ('lqr-lqr_6_2', 'jaco-position_reacher_7DOF')
SLICE11_STEPS = {'lqr-lqr_6_2': 25, 'jaco-position_reacher_7DOF': 1}
# the tasks whose initial states give K1's n = 13 (jaco) and 6 (lqr_6_2)
SLICE11_K1 = ('jaco-position_reacher_7DOF', 'lqr-lqr_6_2')
# jaco: the fence subtracts 1 per extreme joint outside it (3 of them) and
# the action penalty at most 7 x 0.1^2; lqr's reward 1 - cost is unbounded
# below
# the reference gate's physics steps where it holds less than a control
# step: jaco's gate over its 100 RK4 physics steps took 210.7 s of a
# 1,015 s script (PR 15, call 4) and held all 256 lanes with every choice
# matched (largest error 5.31e-4); a quarter of the control step keeps the
# script within its time with the same verdicts
GATE_SUBSTEPS = {'jaco-position_reacher_7DOF': 25}
REWARD_RANGE = {'jaco-position_reacher_7DOF': (-3.07, 1.0),
                'lqr-lqr_6_2': (-math.inf, 1.0)}
# the twelfth slice's tasks (dog: nv 79 for stand, walk, trot and run, 85
# for fetch, past the Newton kernel's 64 dofs, so that their solve takes
# the core with K1b, the JAX package's own route for such layouts; noslip;
# the ellipsoid-box, ellipsoid-cylinder and cylinder-box colliders), their
# kernel-phase generator's seed, the tasks whose initial states give K1's
# n = 79 and 85, and the control steps of each run
SLICE12_TASKS = ('dog-stand', 'dog-walk', 'dog-trot', 'dog-run', 'dog-fetch')
SLICE12_SEED = 70
SLICE12_K1 = ('dog-stand', 'dog-fetch')
SLICE12_STEPS = 2
# the tasks that run in phase slice (exact launch counts) without the
# reference gate: dog's 256-lane gates fail lanes on both K1 routes (row
# zones and limits flipped by float32 drift at the second or third physics
# step, and lanes whose choices all matched past STOP_TOL).  The float32
# Newton solve is the cause (with it at float64 no lane passes REF_TOL),
# and other lanes of the same states fail the port's CPU float32 step
# (`tools/float32_step_probe.py`) and the JAX package's float32 step
# (`tools/reference_step_cpu.py --states`; PERF.md, ROADMAP queue 3);
# `tools/k1_reference_step.py --tasks dog-stand,dog-fetch --lanes 256`
# prints their gates
UNGATED_TASKS = SLICE12_TASKS
# lanes per float64 solve where the kernel phase holds dog's route (its
# (4096, 3822, 85) J is 10.6 GB at float64)
CHUNK = 1024
# the tasks of the sixth to ninth slices, each driven through one
# BatchedEnv of BATCH lanes (phase slice) and gated against the float64 CPU
# path (phase reference, on the rollout's final states); a task's seeds
# follow from its index, so new tasks are appended
SLICE_TASKS = ('cheetah-run', 'hopper-hop', 'pendulum-swingup',
               'reacher-easy', 'cartpole-swingup', 'acrobot-swingup',
               'finger-turn_easy', 'point_mass-easy', 'ball_in_cup-catch',
               'swimmer-swimmer6', 'fish-swim', 'humanoid-run',
               'quadruped-walk') + (SLICE9_TASKS + SLICE10_TASKS
                                    + SLICE11_TASKS + SLICE12_TASKS)
# the index of each slice task's one run: a run's seeds, and so its final
# states, follow from its index, and the reference gate reads its final
# states.  Until the twelfth slice every task took runs 0, 1 and 2 and
# the gate read run 2's; runs 0 and 1 went (a third of the script's
# time) to keep it within its time limit on a slower host, and run 2
# stayed, so every gate holds the states it held before
SLICE_RUN = 2
# the control steps of each run of the sixth to eighth slices' tasks (50
# until the ninth slice cut them, 25 until the eleventh, to keep the
# script within its time; the eleventh slice also cut walker's and
# finger's rollouts to 20 and the ninth slice's runs to 6).  A task's
# reference gate runs on its last run's final states, so a depth is also
# a choice of the gate's states: at 10 control steps (tried), humanoid-
# run's 256-lane gate fails one lane on each K1 route, matched, on float32
# (ROADMAP queue 3, item 1 records them)
SLICE_STEPS = 15
# seeds of the slice's own generators (kernel draws, K2 inputs, the
# reference controls of each task), so that every earlier phase keeps its
# draws
SLICE_SEED = 10
# the seed of the seventh slice's kernel-phase generator (its K1 sizes and
# K2 inputs), so that the draws of every earlier generator stay as they were
SLICE7_SEED = 20
# the seed of the eighth slice's kernel-phase generator (humanoid's and
# quadruped's K2 inputs)
SLICE8_SEED = 30
# the eighth slice's tasks, whose initial states also give K1's n = 27
# and 22 and whose first impacts give K2's largest layouts
SLICE8_TASKS = ('humanoid-run', 'quadruped-walk')
def cones_xml(copies=1):
  """The cone model with its three bodies repeated `copies` times, copy i
  moved i m along x (names suffixed _i past the first): copies=1 is
  CONES_XML (nv 18), copies=2 nv 36, the Newton kernel's two-dofs-per-lane
  family."""
  import xml.etree.ElementTree as ET
  if copies == 1:
    return CONES_XML
  root = ET.fromstring(CONES_XML)
  world = root.find('worldbody')
  bodies = world.findall('body')
  for i in range(1, copies):
    for body in bodies:
      twin = ET.fromstring(ET.tostring(body))
      x, y, z = (float(v) for v in twin.get('pos').split())
      twin.set('pos', f'{x + i} {y} {z}')
      for el in [twin] + list(twin.iter('geom')):
        el.set('name', f'{el.get("name")}_{i}')
      world.append(twin)
  return ET.tostring(root, encoding='unicode')


def cone_states(m, B, rng):
  """qpos (B, nq) and qvel (B, nv), numpy float64, of the cone model (any
  `cones_xml` copies), drawn from the numpy RandomState `rng`, each copy
  alike at its own x: by turns every body on the floor, apart, at a random
  yaw (the floor's condim-6, -4 and -3 cones); the box on the floor with
  the ball on top of it and the rod on the floor, across, an end against
  its side (ball-box condim 6, box-rod condim 4); the rod on the floor
  with the ball on it (ball-rod condim 6); each contact 0 to 1 mm deep,
  velocities N(0, 0.3^2) so that contacts slide.  chip_smoke.py's kernel
  phase and the CPU tests draw the same."""
  import numpy as np
  copies = m.nq // 21
  qpos = np.tile(np.asarray(m.qpos0, np.float64), (B, 1))
  kind = np.arange(B) % 3
  u = lambda lo, hi: rng.uniform(lo, hi, B)

  def yaw_quat(a):
    return np.stack([np.cos(a / 2), 0 * a, 0 * a, np.sin(a / 2)], -1)

  for i in range(copies):
    ball, box, rod = (21 * i + 7 * j for j in range(3))
    sink = [u(0.0, 1e-3) for _ in range(4)]
    x_box, x_rod = i + 0.3 + u(-0.02, 0.02), i - 0.3 + u(-0.02, 0.02)
    yaw = np.where(kind == 0, 1.0, 0.0)
    qpos[:, box:box + 3] = np.stack([x_box, u(-0.02, 0.02),
                                     0.05 - sink[0]], -1)
    qpos[:, box + 3:box + 7] = yaw_quat(yaw * u(-np.pi, np.pi))
    # kind 1: the rod along y, one end against the box's +y face
    y_rod = np.where(kind == 1, qpos[:, box + 1] + 0.18 - sink[1],
                     u(-0.02, 0.02))
    x_rod = np.where(kind == 1, x_box + u(-0.03, 0.03), x_rod)
    qpos[:, rod:rod + 3] = np.stack([x_rod, y_rod, 0.03 - sink[2]], -1)
    qpos[:, rod + 3:rod + 7] = yaw_quat(np.where(
        kind == 1, np.pi / 2, yaw * u(-np.pi, np.pi)))
    ball_xyz = np.stack([
        np.where(kind == 1, x_box, np.where(kind == 2, x_rod, i))
        + u(-0.03, 0.03),
        np.where(kind == 1, qpos[:, box + 1],
                 np.where(kind == 2, y_rod, u(-0.02, 0.02))),
        np.where(kind == 1, 0.217, np.where(kind == 2, 0.177, 0.117))
        - sink[3]], -1)
    qpos[:, ball:ball + 3] = ball_xyz
    quat = rng.randn(B, 4)
    qpos[:, ball + 3:ball + 7] = quat / np.linalg.norm(quat, axis=1,
                                                       keepdims=True)
  return qpos, 0.3 * rng.randn(B, m.nv)


REPLACES = {
    'cholesky_batched': 'dm_control_tpu/ops/linalg_kernel.py:118',
    'chol_solve_batched': 'dm_control_tpu/ops/linalg_kernel.py:142',
    'cho_solve_batched': 'dm_control_tpu/ops/linalg_kernel.py:166',
    'newton_solve_batched': 'dm_control_tpu/ops/newton_kernel.py:491',
    'newton_solve_ell': 'dm_control_tpu/ops/newton_kernel.py:207',
}
SOURCES = {
    'cholesky_batched': 'dm_control_tpu_torch/csrc/linalg_kernel.cu',
    'chol_solve_batched': 'dm_control_tpu_torch/csrc/linalg_kernel.cu',
    'cho_solve_batched': 'dm_control_tpu_torch/csrc/linalg_kernel.cu',
    'newton_solve_batched': 'dm_control_tpu_torch/csrc/newton_kernel.cu',
    'newton_solve_ell': 'dm_control_tpu_torch/csrc/newton_kernel.cu',
}
# K2's bounds (tests/test_pallas.py) on the lane-scaled error
K2_MEAN, K2_MAX, K2_LANES = 1e-4, 5e-2, 0.1


def log(msg):
  print(msg, flush=True)


def expected_launches(task):
  """Each kernel's launches per control step of `task` through
  `forward.substeps` (n = n_sub physics steps): step1 (K1a) runs n + 1
  times (n - 1 in the loop, the sync and the end of step(); n = 1: the
  sync and the end), the acc stage (K1c, then K2, or K2-ell where the
  model's contacts are elliptic, if it has constraint rows) n times, and
  Euler's implicit damping (K1b) n times where a dof is damped.  Under
  RK4 each physics step runs three more pipelines (`forward._forward_core`:
  K1a, K1c, K2) and no K1b.  Past the Newton kernel's dofs (dog) the acc
  stage's solve is the core, which launches no Newton kernel and K1b once
  per iteration of its batch loop: those launches, the loop iterations the
  core reports (`newton_kernel.CORE_LOOPS`), come on top of K1b's count
  here."""
  import numpy as np
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src.types import Integrator
  from dm_control_tpu_torch.ops import newton_kernel as nk
  m, n = task.model, task.n_sub_steps()
  lay = efc.layout(m)
  rk4 = m.opt.integrator == Integrator.RK4
  solves = (4 if rk4 else 1) * n if lay.nefc and m.nv <= nk.MAX_NV else 0
  ell = bool(lay.ell_groups)
  return {'cholesky_batched': n + 1 + (3 * n if rk4 else 0),
          'cho_solve_batched': (4 if rk4 else 1) * n,
          'chol_solve_batched': 0 if rk4 or not np.any(m.dof_damping > 0)
                                else n,
          'newton_solve_batched': 0 if ell else solves,
          'newton_solve_ell': solves if ell else 0}


def core_calls(task):
  """The core's calls per control step of `task`: one per acc stage where
  the model is past the Newton kernel's dofs, else none."""
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch.ops import newton_kernel as nk
  m = task.model
  return (task.n_sub_steps() if efc.layout(m).nefc and m.nv > nk.MAX_NV
          else 0)


def reset_launches(task):
  """Each kernel's launches in one `forward.forward` of `task` (an
  auto-reset of done lanes by a fresh init: K1a in step1, K1c and K2, or
  K2-ell, in the acc stage where the model has constraint rows; past the
  Newton kernel's dofs the core's K1b launches, which `expected_launches`
  counts from its loops)."""
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch.ops import newton_kernel as nk
  lay = efc.layout(task.model)
  ell = bool(lay.ell_groups)
  kernel = bool(lay.nefc) and task.model.nv <= nk.MAX_NV
  return {'cholesky_batched': 1, 'cho_solve_batched': 1,
          'chol_solve_batched': 0,
          'newton_solve_batched': int(kernel and not ell),
          'newton_solve_ell': int(kernel and ell)}


def scaled_err(x, ref):
  return (x - ref).abs() / ref.abs().clamp(min=1.0)


def lane_scaled_err(x, ref):
  """|x - ref| over max(1, the lane's largest |ref|), for (B, n) solves.

  A float32 solve is accurate relative to the size of its lane's vector,
  not of each component: where a lane's qacc reaches ~1e3, a component
  near 1 carries ~1e3 * 6e-8 * cond of rounding whatever the solver."""
  return (x - ref).abs() / ref.abs().amax(dim=1, keepdim=True).clamp(min=1.0)


def cuda_ms(fn, reps):
  """Mean device time of fn() over reps launches (CUDA events)."""
  import torch
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def device_kernels(jobs):
  """{key: (CUDA kernels per call, their device ms per call)} of `jobs`,
  {key: (fn, reps)}, in one torch.profiler session: each fn() called once
  unprofiled, then reps times in the session, the stream synchronised after
  each job.  The session's CUDA kernels, in the order they started, are
  split job by job at one kernel per call; each job's must share one name.
  Fails where the session holds another count than one kernel per call.
  (One session for the whole timing phase: on this card a session that
  followed many others has recorded no kernel at all.)"""
  import torch
  from torch.profiler import ProfilerActivity, profile
  for fn, _ in jobs.values():
    fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for fn, reps in jobs.values():
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
  kernels = sorted((e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA),
                   key=lambda e: e.time_range.start)
  calls = sum(reps for _, reps in jobs.values())
  assert len(kernels) == calls, (
      f'{len(kernels)} CUDA kernels for {calls} wrapper calls: not one each')
  out, start = {}, 0
  for key, (_, reps) in jobs.items():
    mine = kernels[start:start + reps]
    start += reps
    names = {e.name for e in mine}
    assert len(names) == 1, f'{key}: one call launched {names}'
    out[key] = (len(mine) / reps,
                sum(e.device_time for e in mine) / reps / 1e3)
  return out


def bound_ms(nbytes, flops):
  t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
  return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations'


def newton_flops(nefc, nv, ls_iter, iters, cones=None):
  """FLOPs the Newton solve needs for these lanes' iteration counts: the
  warmstart choice and final forces (3 J products and 2 row sweeps), then
  per iteration the H = M + J'WJ build, the Cholesky and substitutions,
  J delta, the line search sweeps, the new cost and the gradient.

  `cones` {k: (B,)}, each lane's active elliptic contacts of k rows
  (`cone_counts`), adds K2-ell's work on them, term by term: ~20 k FLOPs
  to evaluate one cone's residuals, zone, force and cost, done 3x at the
  start and end and (ls_iter + 3)x per iteration (gradient, Hessian, line
  search, new cost); per iteration also its k x k block (3 k^2, the only
  term that grows as k^2), W_c J_c through the block's rank structure
  (6 k nv), the J_c' sweep into H (2 k nv (nv + 1)), its J' f (2 k nv) and
  its line-search phi'/phi'' terms (8 k per step, phi'' from the rank
  structure).  At k = 3 this is the condim-3 count of the earlier slices
  plus the block's 27."""
  start = 3 * 2 * nefc * nv + 2 * nv * nv + 2 * 8 * nefc
  per_iter = (nefc * nv * (nv + 1) + nv ** 3 / 3 + 2 * nv * nv
              + 2 * nefc * nv + 2 * nv * nv + ls_iter * 10 * nefc
              + 2 * nv * nv + 8 * nefc + 2 * nv * nv + 2 * nefc * nv)
  total = len(iters) * start + iters.double().sum().item() * per_iter
  for k, count in (cones or {}).items():
    cone_iter = (20 * k * (ls_iter + 3) + 3 * k * k + 6 * k * nv
                 + 2 * k * nv * (nv + 1) + 2 * k * nv + 8 * k * ls_iter)
    total += (count.double() * (3 * 20 * k + iters.double() * cone_iter)
              ).sum().item()
  return float(total)


def cone_counts(lay, on):
  """{k: (B,)} each lane's active elliptic contacts of k rows, from `on`
  (B, ncg), the cones in condim order as `cone_zones` gives them."""
  out, lo = {}, 0
  for k, (rows, _, _) in sorted(lay.ell_groups.items()):
    out[k] = on[:, lo:lo + len(rows)].sum(dim=1)
    lo += len(rows)
  return out


def ell_bytes(lay, B, nv):
  """Bytes K2-ell must move: K2's (`k2_bytes`) and, once per call, the
  layout's tables: each cone's row scales (k per cone of k rows), its mu,
  and a word per row."""
  n_scales = sum(k * len(rows) for k, (rows, _, _) in lay.ell_groups.items())
  return k2_bytes(B, lay.nefc, nv) + 4 * (n_scales + n_cones(lay) + lay.nefc)


def k2_check(what, x, ref, gate, bounds=None, quiet=False):
  """Print the lane-scaled error of x against ref, and the
  component-scaled one for the record (not when `quiet`); with `gate`,
  assert the K2 bounds (or `bounds`, (mean, max, lanes)) on the
  lane-scaled one.  Returns the lane-scaled (mean, max, lanes above
  1e-3)."""
  B = x.shape[0]
  stats = {}
  for how, err in (('lane-scaled', lane_scaled_err(x, ref)),
                   ('component-scaled', scaled_err(x, ref))):
    mean, mx = err.mean().item(), err.max().item()
    lanes_bad = int((err.max(dim=1).values > 1e-3).sum())
    stats[how] = (mean, mx, lanes_bad)
    if not quiet:
      log(f'#   {what}, {how}: mean {mean:.2e} max {mx:.2e} '
          f'lanes>1e-3 {lanes_bad}')
  if gate:
    b_mean, b_max, b_lanes = bounds or (K2_MEAN, K2_MAX, int(K2_LANES * B))
    mean, mx, lanes_bad = stats['lane-scaled']
    assert mean <= b_mean, f'{what}: mean {mean:.2e} > {b_mean:.2e}'
    assert mx <= b_max, f'{what}: max {mx:.2e} > {b_max:.2e}'
    assert lanes_bad <= b_lanes, f'{what}: {lanes_bad} lanes > {b_lanes}'
  return stats['lane-scaled']


def ell_gates(what, x_k, x_p, x_64, quiet=False):
  """K2's bounds on the kernel's x_k against the plain float32 solve x_p
  and the plain float64 one x_64 (K2-ell's solves, and K1's modes on
  real mass matrices).  Where plain float32 itself misses a
  bound against float64, the kernel is held to no more than 2x plain
  float32's own error on that statistic.  Returns the lane-scaled (mean,
  max, lanes above 1e-3) of the kernel against plain float32 and against
  float64; `quiet` prints none of the statistics."""
  vs_p = k2_check(f'{what} kernel vs plain float32', x_k, x_p, gate=True,
                  quiet=quiet)
  p32 = k2_check(f'{what} plain float32 vs plain float64', x_p.double(),
                 x_64, gate=False, quiet=quiet)
  limits = (K2_MEAN, K2_MAX, int(K2_LANES * x_k.shape[0]))
  bounds = tuple(lim if p <= lim else 2 * p for p, lim in zip(p32, limits))
  if bounds != limits:
    log(f'#   plain float32 misses a K2 bound against float64: the kernel '
        f'is held to (mean, max, lanes) <= {bounds}')
  vs_64 = k2_check(f'{what} kernel vs plain float64', x_k.double(), x_64,
                   gate=True, bounds=bounds, quiet=quiet)
  return vs_p, vs_64


def float32_gates(what, x_k, x_p, x_64):
  """K2's bounds on a kernel solve x_k where the plain float32 solve x_p
  itself misses them against the plain float64 one x_64: on each
  statistic that plain float32 misses, the kernel is held to 2x plain
  float32's own error, against plain float32 as against float64 (two
  float32 solves, each that far from float64, may lie twice that far
  apart); on the others to K2's bounds (`ell_gates` relaxes only the
  float64 side).  For one Newton iteration at humanoid_CMU's layout,
  whose float32 Hessian rounds the step past K2's bounds: plain float32
  against float64 lane-scaled mean 3.74e-4, max 2.17e-2, 36 lanes of 64
  over 1e-3 on its impact states (on the CPU)."""
  p32 = k2_check(f'{what} plain float32 vs plain float64', x_p.double(),
                 x_64, gate=False)
  limits = (K2_MEAN, K2_MAX, int(K2_LANES * x_k.shape[0]))
  bounds = tuple(lim if p <= lim else 2 * p for p, lim in zip(p32, limits))
  if bounds != limits:
    log(f'#   plain float32 misses a K2 bound against float64: the kernel '
        f'is held to (mean, max, lanes) <= {bounds}')
  k2_check(f'{what} kernel vs plain float32', x_k, x_p, gate=True,
           bounds=bounds)
  k2_check(f'{what} kernel vs plain float64', x_k.double(), x_64,
           gate=True, bounds=bounds)


def stop_gates(what, x_k, x_p, x_64, lay, args):
  """K2's bounds lane by lane, for converged solves of which float32
  stops far from the float64 optimum x_64 on some lanes, whichever
  float32 solver it is: there the cost is flat along a direction to
  within float32's resolution (the cone model's condim-6 ball's rolling
  rows, row scale 0.0001 / 0.7), so two float32 solves leave K2's line
  (a lane's lane-scaled error over 1e-3) on lanes that differ.  A float32
  solve's lane over that line is float32-limited where the solve's cost
  (`solve_cost`, at float64 on the solver inputs `args`) stands within
  BAND * EPS32 * scale of the optimum's: no float32 step could find a
  lower one.  The kernel x_k must be within K2's line or float32-limited
  on every lane, with no more such lanes than twice plain float32's x_p,
  plus one; every lane on which neither solve is float32-limited is held
  by `ell_gates`.  The overlap of the two solves' limited lanes and
  their stop distances are printed."""
  import torch

  def cost(x):
    """`solve_cost` at float64, CHUNK lanes at a time."""
    parts = [solve_cost(lay, *[t[i:i + CHUNK].double() for t in args[:7]],
                        x[i:i + CHUNK].double())
             for i in range(0, x.shape[0], CHUNK)]
    return tuple(torch.cat(p) for p in zip(*parts))

  c_64, s_64 = cost(x_64)
  limited, err = {}, {}
  for name, x in (('kernel', x_k), ('plain float32', x_p)):
    c, s = cost(x)
    bands = (c - c_64) / (EPS32 * (s + s_64))
    err[name] = lane_scaled_err(x.double(), x_64).amax(dim=1)
    over = err[name] > 1e-3
    limited[name] = over & (bands <= BAND)
    log(f'#   {what} {name} vs plain float64: {int(over.sum())} lanes over '
        f'1e-3 (largest {err[name].max().item():.2e}), their stop '
        f'distances from the optimum\'s cost at most '
        f'{bands[over].max().item() if over.any() else 0:.3g} bands; '
        f'float32-limited {int(limited[name].sum())}')
    if name == 'kernel':
      assert bool((~over | limited[name]).all()), (
          f'{what}: a kernel lane over 1e-3 whose cost is more than {BAND} '
          f'bands above the optimum\'s')
  k_lim, p_lim = limited['kernel'], limited['plain float32']
  log(f'#   {what}: float32-limited lanes: kernel {int(k_lim.sum())}, plain '
      f'float32 {int(p_lim.sum())}, both {int((k_lim & p_lim).sum())}')
  assert int(k_lim.sum()) <= 2 * int(p_lim.sum()) + 1, (
      f'{what}: the kernel is float32-limited on more than twice plain '
      f'float32\'s lanes, plus one')
  held = ~(k_lim | p_lim)
  if held.any():
    ell_gates(f'{what} on the {int(held.sum())} lanes neither float32 solve '
              f'is limited on', x_k[held], x_p[held], x_64[held])


def n_cones(lay):
  """The layout's elliptic contacts, every condim."""
  return sum(len(rows) for rows, _, _ in lay.ell_groups.values())


def newton_launch(nk, what, lay, nv, B):
  """Print the Newton kernel's launch configuration for a layout."""
  cmax = nk.cone_width(lay)
  warps, smem = nk.launch_config(lay.nefc, nv, n_cones(lay), cmax)
  log(f'# phase kernels: {what} launch: newton_kernel<{1 if nv <= 32 else 2}'
      f', {cmax}>, {warps} warps (one environment each) per block, {smem} '
      f'bytes of dynamic shared memory, {-(-B // warps)} blocks of '
      f'{32 * warps} threads')


def newton_bits(nk, what, args, lay, kw, full):
  """The first B - 3 lanes alone (no multiple of the warps per block)
  and a second launch of the whole batch must give `full`'s bits (x,
  forces, iterations): one warp per environment, sums in a fixed order."""
  import torch
  n = args[0].shape[0] - 3
  again = nk.newton_solve_batched(*args, lay=lay, return_iters=True, **kw)
  part = nk.newton_solve_batched(*[a[:n] for a in args], lay=lay,
                                 return_iters=True, **kw)
  for name, x, y, z in zip(('qacc', 'forces', 'iterations'), full, again,
                           part):
    assert torch.equal(x, y), f'{what}: two launches differ in {name}'
    assert torch.equal(x[:n], z), f'{what}: {n} lanes alone differ in {name}'
  log(f'# phase kernels: {what}: the first {n} lanes alone and a second '
      f'launch give the full batch\'s bits (qacc, forces, iterations)')


def k1_bits(lk, A, b, L, x, xc):
  """The K1 kernel's launch configuration, printed; for K1a, K1b and K1c
  (on K1a's L: `xc`) the first B - 3 lanes alone and a second launch must
  give the full batch's bits (each environment's result depends on its own
  inputs alone); K1c on K1a's L must give K1b's bits (the same factor, the
  same substitution); K1a's L must be exactly 0 above the diagonal and
  unchanged when A's upper triangle is NaN, and K1c's x unchanged when L's
  is (only lower triangles are read)."""
  import torch
  B, n, _ = A.shape
  envs, threads, smem = lk.launch_config(n)
  log(f'# phase kernels: K1 (cholesky_batched, chol_solve_batched, '
      f'cho_solve_batched) n={n} launch: {threads // envs} lanes per '
      f'environment, {envs} environments per block of {threads} threads, '
      f'{smem} bytes of dynamic shared memory, {-(-B // envs)} blocks')
  m = B - 3
  for what, x_full, fn, mat in (
      ('cholesky_batched', L, lambda a, v: lk.cholesky_batched(a), A),
      ('chol_solve_batched', x, lk.chol_solve_batched, A),
      ('cho_solve_batched', xc, lk.cho_solve_batched, L)):
    assert torch.equal(fn(mat, b), x_full), f'{what} n={n}: two launches differ'
    assert torch.equal(fn(mat[:m], b[:m]), x_full[:m]), (
        f'{what} n={n}: {m} lanes alone differ')
  assert torch.equal(xc, x), f'K1c n={n}: on K1a\'s L it is not K1b'
  assert L.is_contiguous(), f'K1a n={n}: L is not contiguous'
  assert bool((torch.triu(L, 1) == 0).all()), f'K1a n={n}: L above diagonal'
  upper = torch.ones(n, n, dtype=torch.bool, device=A.device).triu(1)
  assert torch.equal(lk.cholesky_batched(A.masked_fill(upper, float('nan'))),
                     L), f'K1a n={n}: L depends on the upper triangle'
  assert torch.equal(lk.cho_solve_batched(L.masked_fill(upper, float('nan')),
                                          b), xc), (
      f'K1c n={n}: x depends on the upper triangle of L')
  log(f'# phase kernels: K1 n={n}: cho_solve_batched(cholesky_batched(A), b)'
      f' gives chol_solve_batched(A, b)\'s bits; for each, the first {m} '
      f'lanes alone and a second launch give the full batch\'s bits; L is '
      f'contiguous, 0 above the diagonal, and no upper entry of A or L is '
      f'read')


# the mesh colliders' functions whose results `recording` keeps for
# `mesh_choices` (each called once per pair batch of a mesh group, in group
# order, inside `colliders.collide_all`)
MESH_PROBES = ('mesh_witnesses', 'sphere_mesh_closest', 'plane_mesh_heights')


@contextlib.contextmanager
def recording(record):
  """Inside, every physics step's acc stage of the port (its contacts,
  constraint rows, warmstart and solve) calls record(before, after, seen)
  with the Data going into and out of it and `seen`, what the mesh
  colliders computed for its contacts (each MESH_PROBES function's
  results in call order, from the narrowphase that made them), which
  `mesh_choices` reads instead of running Frank-Wolfe again, and, where
  the model runs noslip, the Newton solve's qacc before it ('newton x',
  which `solve_stop` reads).  The step itself is unchanged."""
  from dm_control_tpu_torch._src import colliders
  from dm_control_tpu_torch._src import forward
  from dm_control_tpu_torch._src import solver
  acc, narrow, noslip = (forward._acc_stage, colliders.collide_all,
                         solver._noslip)
  saved = {f: getattr(colliders, f) for f in MESH_PROBES}
  seen = {f: [] for f in MESH_PROBES + ('newton x',)}

  def probe(f):
    def run(*args):
      out = saved[f](*args)
      seen[f].append(out)
      return out
    return run

  def collide_all(m, d):
    for f in MESH_PROBES:
      seen[f].clear()
    return narrow(m, d)

  def noslip_probe(m, lay, d, x, force):
    seen['newton x'].append(x)
    return noslip(m, lay, d, x, force)

  def probed(m, d, skipsensor=False):
    out = acc(m, d, skipsensor=skipsensor)
    record(d, out, {f: list(v) for f, v in seen.items()})
    seen['newton x'].clear()
    return out

  forward._acc_stage, colliders.collide_all = probed, collide_all
  solver._noslip = noslip_probe
  for f in MESH_PROBES:
    setattr(colliders, f, probe(f))
  try:
    yield
  finally:
    forward._acc_stage, colliders.collide_all = acc, narrow
    solver._noslip = noslip
    for f, fn in saved.items():
      setattr(colliders, f, fn)


def one_step(m, data, lanes, ctrl, n_sub, dtype, dev, record=False):
  """qpos, qvel and (where the model has activations) act after one
  control step (n_sub substeps) of `data`'s `lanes` under `ctrl`, run by
  the port's model m at dtype on dev; with `record`, also the discrete
  choices of every acc stage (`branches`, on the CPU) under 'branches'."""
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src import forward
  small = forward.map_state(
      lambda x: x[lanes].to(dev, dtype) if x.is_floating_point()
      else x[lanes].to(dev), forward.state_of(data))
  d = forward.make_data(m, ctrl.shape[0], dtype, dev).replace(**small)
  kept = []
  lay = efc.layout(m)
  keep = lambda before, after, seen: kept.append(
      {q: tuple(None if t is None else t.cpu() for t in v)
       for q, v in branches(m, lay, before, after, seen).items()})
  with recording(keep) if record else contextlib.nullcontext():
    d = forward.substeps(m, d.replace(ctrl=ctrl.to(dev, dtype)), n_sub)
  out = {f: getattr(d, f) for f in state_fields(m)}
  if record:
    out['branches'] = kept
  return out


def state_fields(m):
  """The state the reference gate compares: qpos, qvel, and act where the
  model has activations."""
  return ('qpos', 'qvel') + (('act',) if m.na else ())


# -- the reference-step gate ---------------------------------------------------
# One control step on the card at float32 is held against the float64 CPU
# path lane by lane.  A lane on which every discrete choice of every acc
# stage (`branches`) came out as in the float64 run is held to REF_TOL,
# unless its float32 Newton solves all stopped where float32 can no
# longer tell their cost from the optimum's: then it is excused up to
# STOP_TOL.  A lane whose choices differ may be further off: it took
# another branch of the physics.  It is excused where, at its first
# differing stage, the first quantity that differs (in pipeline order)
# stood within BAND * EPS32 * scale of its threshold in the float64 run
# on every differing element: a choice that float32 rounding flips.  Any
# other lane over REF_TOL fails; the excused lanes are counted against
# the same step run with K1 as plain PyTorch (`gate_failures`).  A lane
# that fails is judged again against the float64 path run on the CPU for
# the failed lanes alone (`cpu_reference`).  PERF.md derives BAND and
# shows what flips.
REF_TOL = 1e-2
EPS32 = 2.0 ** -23          # float32 spacing at 1 (torch.finfo().eps)
BAND = 64
REF_LANES = 256             # lanes of each task the gate holds
REF_SEED = 2                # the reference generator's seed
# pipeline order: the top-K selection, the box colliders' choices,
# collision (and the heightfield cell of each active contact), limits,
# then the solve's warmstart choice and the zones of its rows and cones at
# the solution
QUANTITIES = ('selection', 'box corners', 'box axis', 'mesh sep',
              'mesh inside', 'mesh corners', 'contact',
              'hfield cell', 'contact core', 'contact normal', 'limit',
              'tendon limit', 'warmstart', 'row zone', 'cone top',
              'cone bottom')
# two runs' normals of one contact differ where they are further apart
NORMAL_ANGLE = 0.1
# the separation below which math.normalize clamps (its eps): a pair whose
# cores cross takes its normal and contact point from rounding there
CORE_EPS = 1e-12
# a matched lane whose solves all stopped within the band is excused up to
# K2's largest error for two float32 Newton solves (tests/test_pallas.py)
STOP_TOL = 5e-2
# the float64 solve of `solve_stop`: iterations and tolerance
STOP_ITERATIONS, STOP_TOL64 = 100, 1e-10


def solve_cost(lay, J, M, aref, D, fl, act, a, x):
  """The Newton solve's cost at x for one acc stage's inputs (act the
  active rows as 0/1), and its first-order rounding scale: the
  quadratic's terms, and each row's |force| times its jar's scale
  sum |J| |x| + |aref|."""
  import torch
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch.ops import newton_kernel as nk
  types = torch.as_tensor(lay.types, device=J.device)
  groups = nk._ell_groups(lay.ell_groups, J.device, J.dtype)
  mv = lambda A, v: torch.einsum('buv,bv->bu', A, v)
  jar = mv(J, x) - aref
  f, _, c = nk._diag_terms(jar, D, fl, act, types == efc.EQUALITY,
                           types == efc.FRICTION, types == efc.ONESIDED)
  if groups:
    f_e, c_e, _ = nk._ell_terms(jar, D, act, groups)
    f, c = f + f_e, c + c_e
  xa = x - a
  quad = 0.5 * (xa * mv(M, xa)).sum(-1)
  scale = (xa.abs() * mv(M.abs(), xa.abs())).sum(-1)
  jscale = mv(J.abs(), x.abs()) + aref.abs()
  return quad + c, scale + (f.abs() * jscale).sum(-1)


def solve_stop(m, lay, d, x=None):
  """Where one acc stage's float32 Newton solve stopped: cost(x32) -
  cost(x*), at float64 on the run's device, x32 being the stage's
  solution (d.qacc, or `x`, the Newton solve's own where noslip moved
  d.qacc off it) and x* the plain float64 solve of the stage's own
  inputs (J, D, aref, friction loss, active rows and cones, M,
  qacc_smooth) from x32, to STOP_TOL64; its scale the sum of the two
  costs' `solve_cost` scales, as the warmstart choice's.  Returns (None,
  value (B, 1), scale (B, 1))."""
  import torch
  from dm_control_tpu_torch._src import solver
  from dm_control_tpu_torch.ops import newton_kernel as nk
  f64 = lambda t: t.detach().to(torch.float64)
  args = [f64(t) for t in (d.efc_J, d.qM, d.efc_aref, d.efc_D,
                           d.efc_frictionloss, d.efc_active, d.qacc_smooth)]
  x32 = f64(d.qacc if x is None else x)
  x64, _ = nk.newton_solve_plain(
      *args, x32, types=lay.types, ell_groups=lay.ell_groups,
      niter=STOP_ITERATIONS, ls_iter=solver.LS_ITERATIONS, tol=STOP_TOL64,
      meaninertia=float(m.stat_meaninertia or 1.0))
  (c32, s32), (c64, s64) = (solve_cost(lay, *args, x) for x in (x32, x64))
  return None, (c32 - c64)[:, None], (s32 + s64)[:, None]


def selected_pairs(m, con, g, slot):
  """(B, K) the pair index in dynamic group `g` (whose contacts start at
  `slot`) of each pair the lanes' contacts hold, in their order."""
  import numpy as np
  import torch
  lut = np.full(m.ngeom * m.ngeom, -1)
  lut[g.g1 * m.ngeom + g.g2] = np.arange(g.npairs)
  first = slice(slot, slot + g.ncon, g.ncon_per_pair)
  pair = torch.as_tensor(lut, device=con.dist.device)[
      con.geom1[:, first].long() * m.ngeom + con.geom2[:, first].long()]
  assert bool((pair >= 0).all()), 'a contact of no candidate pair'
  return pair


def keys_per_pair(g):
  """The keys `contact_keys` gives each candidate pair of group g: one per
  contact, or for plane-box one per box corner."""
  from dm_control_tpu_torch._src.types import GeomType
  return 8 if (g.t1, g.t2) == (GeomType.PLANE, GeomType.BOX) else (
      g.ncon_per_pair)


def plane_box_corners(m, d, g):
  """(B, npairs, 8) each plane-box pair's box corner heights over the
  plane, and (B, npairs, 4) the corners its 4 contact slots hold
  (recomputed from d's geom poses at d's dtype, as `_plane_box` chose
  them)."""
  import torch
  from dm_control_tpu_torch._src import colliders
  from dm_control_tpu_torch._src.types import mirror
  ref = d.qpos
  g1, g2 = mirror(m, ref, g.g1), mirror(m, ref, g.g2)
  _, heights = colliders.plane_box_heights(
      d.geom_xpos[:, g1], d.geom_xmat[:, g1], d.geom_xpos[:, g2],
      d.geom_xmat[:, g2], mirror(m, ref, m.geom_size[g.g2]))
  return heights, torch.argsort(heights, dim=-1, stable=True)[..., :4]


def contact_keys(m, con, d=None):
  """(keys (B, ncon), number of keys): each contact slot's place among
  every candidate contact of the model, pair by pair.  A static group's
  slots keep their places; a dynamic (top-K) group's slot i * k + j, which
  holds the pair its lane selected i-th, takes that pair's place (pair
  index * k + j), so that two runs' contacts of one pair meet whatever
  order their selections took; a plane-box slot takes its box corner's
  place (pair index * 8 + corner, the corners `plane_box_corners` reads
  off d; in a top-K plane-box group, of the pair its lane selected), so
  that two runs' contacts of one corner meet whatever order their 4
  equally deep corners took.  Keys are None where the model has
  no such group: then slots are keys."""
  import torch
  from dm_control_tpu_torch._src import collision
  groups = collision.groups(m)
  if all(keys_per_pair(g) == g.ncon_per_pair and not g.dynamic
         for g in groups):
    return None, con.dist.shape[1]
  B, dev = con.dist.shape[0], con.dist.device
  keys, slot, key = [], 0, 0
  for g in groups:
    k, kp = g.ncon_per_pair, keys_per_pair(g)
    if g.dynamic and kp != k:
      # a top-K plane-box group: each selected pair's slots by box corner
      pair = selected_pairs(m, con, g, slot)
      corner = torch.take_along_dim(plane_box_corners(m, d, g)[1],
                                    pair[..., None], dim=1)
      keys.append(key + (pair[..., None] * kp + corner).reshape(B, -1))
    elif g.dynamic:
      pair = selected_pairs(m, con, g, slot)
      keys.append(key + (pair[..., None] * k + torch.arange(k, device=dev)
                         ).reshape(B, -1))
    elif kp != k:
      corner = plane_box_corners(m, d, g)[1]
      keys.append(key + (torch.arange(g.npairs, device=dev)[:, None] * kp
                         + corner).reshape(B, -1))
    else:
      keys.append(torch.arange(key, key + g.ncon, device=dev).expand(B, -1))
    slot += g.ncon
    key += g.npairs * kp
  return torch.cat(keys, dim=1), key


def row_keys(m, lay, ckeys):
  """(keys (B, nefc), number of keys) of the efc rows from the contacts'
  `contact_keys`: the rows before the contacts keep their places, a
  contact's rows follow its key (its group's rows per contact each)."""
  import numpy as np
  import torch
  from dm_control_tpu_torch._src import collision
  n_nc, c = lay.n_noncontact, lay.contact
  per_con = np.diff(np.append(c.row_start, lay.nefc))
  B, dev = ckeys.shape[0], ckeys.device
  keys = [torch.arange(n_nc, device=dev).expand(B, -1)]
  slot, key, rkey = 0, 0, n_nc
  for g in collision.groups(m):
    r = int(per_con[slot])
    assert (per_con[slot:slot + g.ncon] == r).all()
    local = ckeys[:, slot:slot + g.ncon] - key
    keys.append((rkey + local[..., None] * r
                 + torch.arange(r, device=dev)).reshape(B, -1))
    slot += g.ncon
    key += g.npairs * keys_per_pair(g)
    rkey += g.npairs * keys_per_pair(g) * r
  return torch.cat(keys, dim=1), rkey


def by_key(x, keys, n, fill):
  """x (B, slots, ...) placed at `keys` (B, slots) of a (B, n, ...)
  tensor of `fill`; x itself where keys is None."""
  import torch
  if keys is None:
    return x
  out = torch.full((x.shape[0], n) + x.shape[2:], fill, dtype=x.dtype,
                   device=x.device)
  return out.scatter_(1, keys.reshape(keys.shape + (1,) * (x.dim() - 2))
                      .expand_as(x), x)


def selection(m, d):
  """The 'selection' quantity of `branches` over the dynamic groups: each
  candidate pair's selected state (read off d's contacts), the group's
  score gap between its K-th and (K+1)-th candidate (recomputed from d's
  geom poses at d's dtype), scale max(1, |contact position|) of the
  group's contacts."""
  import torch
  from dm_control_tpu_torch._src import colliders
  from dm_control_tpu_torch._src import collision
  con = d.contact
  parts, slot = [], 0
  for g in collision.groups(m):
    if g.dynamic:
      _, score = colliders.broadphase_select(m, d, g)
      ranked = torch.sort(score, dim=1, stable=True).values
      gap = (ranked[:, g.K] - ranked[:, g.K - 1])[:, None]
      chosen = torch.zeros(score.shape, dtype=torch.bool,
                           device=score.device)
      chosen.scatter_(1, selected_pairs(m, con, g, slot), True)
      scale = con.pos[:, slot:slot + g.ncon].abs().amax(dim=(1, 2)).clamp(
          min=1.0)[:, None]
      parts.append((chosen, gap.expand_as(score), scale.expand_as(score)))
    slot += g.ncon
  return tuple(torch.cat(x, dim=1) for x in zip(*parts))


def box_choices(m, d):
  """The box colliders' discrete choices (quantities of `branches`), per
  pair of the box groups (of a top-K plane-box group, dog-fetch's, where
  the lane selected the pair: else no choice, its state False and its
  value inf), each recorded only where it can matter and its value the
  nearer of the choice's own margin and that reach's:
    box corners  per plane-box pair and box corner, whether the pair's
                 4 contacts hold it, where the 4th deepest corner is
                 within its contact margin (else no corner): value the
                 smaller of the 4th-to-5th height gap and |4th height -
                 margin|
    box axis     per box-box pair, the axis its manifold is built on (the
                 first largest of `colliders.box_box_axes`' 15
                 candidates: A's faces, B's faces, the edges), where a
                 contact of the pair is active (else -1): value the
                 smaller of the gap between the two largest candidates
                 and |the pair's smallest dist - margin|
  scale max(1, |the geoms' positions|)."""
  import torch
  from dm_control_tpu_torch._src import colliders
  from dm_control_tpu_torch._src import collision
  from dm_control_tpu_torch._src.types import GeomType, mirror
  con, ref = d.contact, d.qpos
  out, slot = {}, 0
  for g in collision.groups(m):
    if GeomType.BOX in (g.t1, g.t2) and g.t1 in (GeomType.PLANE,
                                                 GeomType.BOX):
      assert not g.dynamic or g.t1 == GeomType.PLANE, (
          f'a top-K {g.t1.name.lower()}-{g.t2.name.lower()} group')
      g1, g2 = mirror(m, ref, g.g1), mirror(m, ref, g.g2)
      scale = torch.maximum(d.geom_xpos[:, g1].abs().amax(-1),
                            d.geom_xpos[:, g2].abs().amax(-1)).clamp(min=1.0)
      margin = mirror(m, ref, g.margin - g.gap).expand(ref.shape[0], -1)
      if g.t1 == GeomType.PLANE:
        heights, corner = plane_box_corners(m, d, g)
        ranked = torch.sort(heights, dim=-1, stable=True).values
        h4 = ranked[..., 3] - margin
        value = torch.minimum(ranked[..., 4] - ranked[..., 3], h4.abs())
        held = torch.zeros_like(heights, dtype=torch.bool).scatter_(
            -1, corner, True) & (h4 < 0)[..., None]
        if g.dynamic:
          # a top-K group's pair makes a choice only where the lane
          # selected it
          chosen = torch.zeros_like(h4, dtype=torch.bool).scatter_(
              1, selected_pairs(m, con, g, slot), True)
          held = held & chosen[..., None]
          value = torch.where(chosen, value, float('inf'))
        part = ('box corners', (held.flatten(1),
                                value[..., None].expand(heights.shape)
                                .flatten(1),
                                scale[..., None].expand(heights.shape)
                                .flatten(1)))
      else:
        dist = con.dist[:, slot:slot + g.ncon].reshape(
            -1, g.npairs, g.ncon_per_pair)
        cand = colliders.box_box_axes(
            d.geom_xpos[:, g1], d.geom_xmat[:, g1],
            mirror(m, ref, m.geom_size[g.g1]), d.geom_xpos[:, g2],
            d.geom_xmat[:, g2], mirror(m, ref, m.geom_size[g.g2]))[-1]
        top2 = torch.topk(cand, 2, dim=-1).values
        reach = dist.amin(-1) - margin
        axis = torch.where(reach < 0, torch.argmax(cand, dim=-1), -1)
        part = ('box axis', (axis, torch.minimum(top2[..., 0] - top2[..., 1],
                                                 reach.abs()), scale))
      q, x = part
      out[q] = (tuple(torch.cat([a, b], dim=1) for a, b in zip(out[q], x))
                if q in out else x)
    slot += g.ncon
  return out


def mesh_choices(m, d, seen=None):
  """The mesh colliders' discrete choices (quantities of `branches`), per
  candidate pair of each mesh group (a top-K group's where the lane
  selected the pair: else no choice, its state False and its value inf),
  from what the colliders computed for d's contacts where `seen` holds it
  (`recording`: each MESH_PROBES function's results in call order, all
  read here), else recomputed from d's geom poses at d's dtype (the same
  arithmetic on the same inputs):
    mesh sep     per mesh-mesh or box-mesh pair, whether its Frank-Wolfe
                 witnesses are more than 1e-7 apart (`_mesh_mesh` then
                 takes their distance, else minus the support overlap with
                 the normal between the hulls' vertex means): value the
                 separation less 1e-7
    mesh inside  per sphere-mesh pair (a capsule-mesh pair's two ends),
                 whether the center is within 1e-9 of the hull (its normal
                 then from the hull's vertex mean): value the distance
                 less 1e-9
    mesh corners per plane-mesh pair and hull vertex, whether the pair's 3
                 contacts hold it (the stable sort's three deepest): value
                 the gap between the 3rd and 4th deepest heights, the
                 padding's repeats of a hull's first vertex not counted
  scale max(1, |the geoms' positions|).  {} where the model has no mesh
  group."""
  import numpy as np
  import torch
  from dm_control_tpu_torch._src import colliders
  from dm_control_tpu_torch._src import collision
  from dm_control_tpu_torch._src import math as pmath
  from dm_control_tpu_torch._src.types import GeomType, mirror
  con, ref = d.contact, d.qpos
  B = ref.shape[0]
  out, slot = {}, 0
  for g in collision.groups(m):
    if g.t2 != GeomType.MESH:
      slot += g.ncon
      continue
    if g.dynamic:
      pair = selected_pairs(m, con, g, slot)                   # (B, K)
    else:
      pair = torch.arange(g.npairs, device=ref.device).expand(B, -1)
    g1 = mirror(m, ref, g.g1)[pair]
    g2 = mirror(m, ref, g.g2)[pair]
    take = lambda x, gi: torch.take_along_dim(
        x, gi.reshape(gi.shape + (1,) * (x.dim() - 2)), dim=1)
    pos1, mat1 = take(d.geom_xpos, g1), take(d.geom_xmat, g1)
    pos2, mat2 = take(d.geom_xpos, g2), take(d.geom_xmat, g2)
    size1 = mirror(m, ref, m.geom_size)[g1]
    hulls2 = colliders._hulls(m, ref, g2)
    scale = torch.maximum(pos1.abs().amax(-1), pos2.abs().amax(-1)).clamp(
        min=1.0)
    if g.t1 in (GeomType.MESH, GeomType.BOX):
      hulls1 = (colliders._hulls(m, ref, g1) if g.t1 == GeomType.MESH
                else size1[..., None, :] * torch.as_tensor(
                    colliders._BOX_SIGNS, dtype=ref.dtype,
                    device=ref.device))
      _, _, c1, c2 = (seen['mesh_witnesses'].pop(0) if seen else
                      colliders.mesh_witnesses(pos1, mat1, pos2, mat2,
                                               hulls1, hulls2))
      value = pmath.norm_safe(c2 - c1) - 1e-7
      q, state, per = 'mesh sep', value > 0, 1
    elif g.t1 in (GeomType.SPHERE, GeomType.CAPSULE):
      ends = [pos1]
      if g.t1 == GeomType.CAPSULE:
        axis, hl = mat1[..., :, 2], size1[..., 1:2]
        ends = [pos1 + hl * axis, pos1 - hl * axis]
      value = torch.stack([pmath.norm_safe(
          (seen['sphere_mesh_closest'].pop(0) if seen else
           colliders.sphere_mesh_closest(e, pos2, mat2, hulls2))[1] - e)
                           for e in ends], -1) - 1e-9
      q, state, per = 'mesh inside', value < 0, len(ends)
      scale = scale[..., None].expand(value.shape)
    else:                                   # plane
      _, h = (seen['plane_mesh_heights'].pop(0) if seen else
              colliders.plane_mesh_heights(pos1, mat1, pos2, mat2, hulls2))
      n_hull = np.array([len(v) for v in m.mesh_hull])
      real = torch.as_tensor(
          np.arange(colliders._HULL_PAD)[None, :] < n_hull[:, None],
          device=ref.device)[mirror(m, ref, m.geom_dataid)[g2]]
      held = torch.zeros_like(h, dtype=torch.bool).scatter_(
          -1, torch.argsort(h, dim=-1, stable=True)[..., :3], True)
      ranked = torch.sort(torch.where(real, h, float('inf')), dim=-1).values
      value = (ranked[..., 3] - ranked[..., 2])[..., None].expand(h.shape)
      q, state, per = 'mesh corners', held, colliders._HULL_PAD
      scale = scale[..., None].expand(h.shape)
    state, value, scale = (x.reshape(B, -1) for x in (state, value, scale))
    if g.dynamic:                  # keyed by pair: unselected pairs hold none
      keys = (pair[..., None] * per + torch.arange(per, device=ref.device)
              ).reshape(B, -1)
      n = g.npairs * per
      state, value, scale = (by_key(x, keys, n, fill) for x, fill in (
          (state, False), (value, float('inf')), (scale, 1.0)))
    x = (state, value, scale)
    out[q] = (tuple(torch.cat([a, b], dim=1) for a, b in zip(out[q], x))
              if q in out else x)
    slot += g.ncon
  assert not seen or not any(seen.get(f) for f in MESH_PROBES), (
      'a mesh collider call unread')
  return out


def hfield_cells(m, d):
  """The 'hfield cell' quantity of `branches`, per contact of the static
  heightfield groups: the grid cell (y0 * ncol + x0) under its point where
  the contact is active (else -1), recomputed from d's geom poses at d's
  dtype as `colliders.hfield_points` and `hfield_grid` place it (the cell
  picks the bilinear patch, hence the contact's normal); value the
  point's distance to the nearest cell edge (the grid fraction's nearer
  side times the spacing); scale max(1, |contact position|).  {} where
  the model has no heightfield."""
  import torch
  from dm_control_tpu_torch._src import colliders
  from dm_control_tpu_torch._src import collision
  from dm_control_tpu_torch._src.types import GeomType, mirror
  con, ref = d.contact, d.qpos
  parts, slot = [], 0
  for g in collision.groups(m):
    if g.t1 == GeomType.HFIELD:
      assert not g.dynamic, 'a top-K heightfield group'
      hid = int(m.geom_dataid[g.g1[0]])
      g1, g2 = mirror(m, ref, g.g1), mirror(m, ref, g.g2)
      h_pos, h_mat = d.geom_xpos[:, g1], d.geom_xmat[:, g1]
      pts = colliders.hfield_points(g, h_mat, d.geom_xpos[:, g2],
                                    d.geom_xmat[:, g2],
                                    mirror(m, ref, m.geom_size[g.g2]))
      local = torch.stack([torch.einsum('...ij,...i->...j', h_mat, p - h_pos)
                           for p, _ in pts], 2)              # (B, K, k, 3)
      x0, y0, tx, ty = colliders.hfield_grid(m, hid, local[..., :2])
      nrow, ncol = int(m.hfield_nrow[hid]), int(m.hfield_ncol[hid])
      dx, dy = (2 * float(v) / (n - 1) for v, n in zip(
          m.hfield_size[hid][:2], (ncol, nrow)))
      edge = torch.minimum(torch.minimum(tx, 1 - tx) * dx,
                           torch.minimum(ty, 1 - ty) * dy).flatten(1)
      n = g.ncon
      on = (con.dist[:, slot:slot + n] - con.includemargin[:, slot:slot + n]
            ) < 0
      cell = torch.where(on, (y0 * ncol + x0).flatten(1), -1)
      scale = con.pos[:, slot:slot + n].abs().amax(-1).clamp(min=1.0)
      parts.append((cell, edge, scale))
    slot += g.ncon
  if not parts:
    return {}
  return {'hfield cell': tuple(torch.cat(x, dim=1) for x in zip(*parts))}


def cone_keys(lay, ckeys, rows):
  """(B, ncg) the `contact_keys` of the contacts whose elliptic cones
  have normal rows rows[:, 0]."""
  import numpy as np
  import torch
  start = lay.contact.row_start
  con = np.searchsorted(start, rows[:, 0])
  assert (start[con] == rows[:, 0]).all()
  return ckeys[:, torch.as_tensor(con, device=ckeys.device)]


def branches(m, lay, before, after, seen=None):
  """The discrete choices one physics step's acc stage made, lane by lane.

  `before` / `after`: the Data going into / out of the acc stage;
  `seen`, what its mesh colliders computed (`recording`, read by
  `mesh_choices`).  For each quantity of QUANTITIES the model has:
  (state (B, k), value (B, k),
  scale (B, k)), state being the predicate the pipeline applies to value
  (< 0 or <= 0; for normals the direction itself), computed at the run's
  dtype, and scale the size of the terms value is computed from, so that
  value's rounding is ~ eps * scale:
    selection  per candidate pair of each dynamic (top-K) group, whether
               the lane selected it (`selection`): decided by the gap
               between the group's K-th and (K+1)-th score; scale max(1,
               |contact position|) of the group's contacts
    box corners, box axis  which corners a plane-box pair's contacts
               hold, and the axis a box-box pair's manifold is built on
               (`box_choices`)
    mesh sep, mesh inside, mesh corners  the mesh colliders' switches:
               witnesses 1e-7 apart, a sphere's center within 1e-9 of a
               hull, a plane-mesh pair's three deepest vertices
               (`mesh_choices`)
    contact    dist - margin < 0 per candidate contact (constraint.py);
               scale max(1, |contact position|)
    hfield cell  the heightfield cell under each active heightfield
               contact (`hfield_cells`): decided by its distance to the
               nearest cell edge
    contact core  the separation of the two geoms' cores, dist + their
               radii, < CORE_EPS: where math.normalize clamps it, the pair's
               normal and contact point are rounding's; same scale
    contact normal  the normal of each active contact, a direction (two
               runs' differ past NORMAL_ANGLE): decided by the separation
               of the cores, same scale
    limit      dist - margin < 0 per joint limit; scale max(1, |dist| +
               |range|)
    tendon limit  dist - margin < 0 per tendon limit (a string going
               taut), the nearer side's; scale max(1, |dist| + |range|)
    warmstart  cost(warm) - cost(qacc_smooth) < 0 (the solve's start);
               scale the costs' first-order rounding: their quadratic
               terms, and each row's |force| times its jar's scale
    row zone   at the solution x, active one-sided rows jar < 0, friction-
               loss rows D |jar| - fl <= 0 (newton_kernel._diag_terms); jar
               = J x - aref, scale sum |J| |x| + |aref| plus |J| times x's
               own rounding scale through the solve (times D, plus fl)
    cone top / cone bottom: active elliptic contacts of every condim
               (3, 4 and 6, in condim order), mu t - n <= 0 and
               mu n + t <= 0 (newton_kernel._ell_terms), on the scaled
               residuals, t over all of a cone's friction rows; scale the
               same sums for n and t
  and, for a float32 run with constraint rows, 'solve stop' (`solve_stop`
  at the Newton solve's own qacc, before noslip where the model runs it:
  no choice, so no state; `first_differences` does not read it,
  `stop_distances` does).  Where the model has dynamic groups, the
  contact quantities and the row zones are keyed by pair (`contact_keys`,
  `row_keys`), not by slot: a reorder inside the selected set is no
  choice and records nothing, and a pair left unselected records no
  contact (its value inf, its normal NaN).  Plane-box contacts are keyed
  by box corner (`contact_keys`) in the same way, and the cones follow
  their contacts' keys (`cone_keys`).
  """
  import numpy as np
  import torch
  from dm_control_tpu_torch._src import collision
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src.types import DisableBit, GeomType
  from dm_control_tpu_torch.ops import newton_kernel as nk
  d = after
  out = {}
  ckeys = rkeys = None
  if lay.contact is not None and lay.contact.ncon:
    con = d.contact
    ckeys, n_keys = contact_keys(m, con, d)
    key = lambda x, fill: by_key(x, ckeys, n_keys, fill)
    v = con.dist - con.includemargin
    scale = key(con.pos.abs().amax(-1).clamp(min=1.0), 1.0)
    if ckeys is not None:
      if any(g.dynamic for g in collision.groups(m)):
        out['selection'] = selection(m, d)
      rkeys, n_rows = row_keys(m, lay, ckeys)
    out.update(box_choices(m, d))
    out.update(mesh_choices(m, d, seen))
    out['contact'] = (key(v < 0, False), key(v, float('inf')), scale)
    out.update(hfield_cells(m, d))
    radius = torch.as_tensor(m.geom_size[:, 0], dtype=v.dtype,
                             device=v.device)
    # planes, boxes and meshes have no core radius: a sphere's core is
    # then its center, which crossing a box's surface flips sphere-box's
    # normal
    radius = torch.where(torch.as_tensor(
        (m.geom_type == GeomType.PLANE) | (m.geom_type == GeomType.BOX)
        | (m.geom_type == GeomType.MESH), device=v.device), 0.0, radius)
    sep = con.dist + radius[con.geom1.long()] + radius[con.geom2.long()]
    out['contact core'] = (key(sep < CORE_EPS, False),
                           key(sep - CORE_EPS, float('inf')), scale)
    normal = torch.where((v < 0)[..., None], con.frame[..., 0, :],
                         float('nan'))
    out['contact normal'] = (key(normal, float('nan')),
                             key(sep, float('inf')), scale)
  # the equality rows come first, then the friction-loss rows; the limit
  # rows follow them: joints, balls, tendons
  n_eq = int((lay.types == efc.EQUALITY).sum())
  lo_jnt = n_eq + len(lay.fric_dof) + len(lay.fric_ten)
  lo_ten = lo_jnt + len(lay.lim_jnt) + len(lay.lim_ball)
  for q, lo, ids, ranges in (
      ('limit', lo_jnt, lay.lim_jnt, m.jnt_range),
      ('tendon limit', lo_ten, lay.lim_ten, m.tendon_range)):
    hi = lo + len(ids)
    if hi > lo:
      pos = d.efc_pos[:, lo:hi]
      v = pos - d.efc_margin[:, lo:hi]
      rng = torch.as_tensor(np.abs(ranges[ids]).max(-1), dtype=v.dtype,
                            device=v.device)
      out[q] = (v < 0, v, (pos.abs() + rng).clamp(min=1.0))
  if lay.nefc == 0:
    return out
  J, aref, D, fl = d.efc_J, d.efc_aref, d.efc_D, d.efc_frictionloss
  on = d.efc_active
  act = on.to(J.dtype)
  types = torch.as_tensor(lay.types, device=J.device)
  is_eq, is_fr = types == efc.EQUALITY, types == efc.FRICTION
  is_one = types == efc.ONESIDED
  groups = nk._ell_groups(lay.ell_groups, J.device, J.dtype)
  mv = lambda A, x: torch.einsum('buv,bv->bu', A, x)

  def jar_scale(x):
    return torch.einsum('buv,bv->bu', J.abs(), x.abs()) + aref.abs()

  def cost(x):
    return solve_cost(lay, J, d.qM, aref, D, fl, act, d.qacc_smooth, x)

  warm = (d.qacc_smooth if m.opt.disableflags & DisableBit.WARMSTART
          else before.qacc_warmstart)
  (c_warm, s_warm), (c_smooth, s_smooth) = cost(warm), cost(d.qacc_smooth)
  out['warmstart'] = ((c_warm < c_smooth)[:, None],
                      (c_warm - c_smooth)[:, None],
                      (s_warm + s_smooth)[:, None])
  # the zones at the solution x: their values come through the solve, so
  # their scale adds x's first-order rounding, |H^-1| times the gradient's
  # terms' sizes |M| (|x| + |a|) + |J'| |f| (H the solve's Hessian at x)
  x = d.qacc
  jar = mv(J, x) - aref
  f, w, _ = nk._diag_terms(jar, D, fl, act, is_eq, is_fr, is_one)
  h = d.qM + torch.einsum('bev,be,beu->bvu', J, w, J)
  if groups:
    f_e, _, blocks = nk._ell_terms(jar, D, act, groups)
    f = f + f_e
    for rows, W in blocks:
      h = h + torch.einsum('bcjv,bcjk,bckw->bvw', J[:, rows], W, J[:, rows])
  g_terms = (mv(d.qM.abs(), x.abs() + d.qacc_smooth.abs())
             + torch.einsum('bev,be->bv', J.abs(), f.abs()))
  x_res = mv(torch.linalg.inv(h).abs(), g_terms)
  jscale = jar_scale(x) + mv(J.abs(), x_res)
  inf = torch.full_like(jar, float('inf'))
  v_fr = D * jar.abs() - fl
  zone = (on & ((is_one & (jar < 0)) | (is_fr & (v_fr <= 0))),
          torch.where(is_one, jar, torch.where(is_fr, v_fr, inf)),
          torch.where(is_one, jscale, torch.where(is_fr, D * jscale + fl,
                                                  inf)))
  if rkeys is not None:
    zone = (by_key(zone[0], rkeys, n_rows, False),
            by_key(zone[1], rkeys, n_rows, float('inf')),
            by_key(zone[2], rkeys, n_rows, float('inf')))
  out['row zone'] = zone
  tops, bottoms = [], []
  for rows, mu, s in groups:
    y = jar[:, rows] * s
    ys = jscale[:, rows] * s.abs()
    n, t = y[..., 0], torch.sqrt(torch.clamp((y[..., 1:] ** 2).sum(-1),
                                             min=1e-30))
    scale = ys[..., 0] + mu * ys[..., 1:].norm(dim=-1)
    c_on = on[:, rows[:, 0]]
    v_top, v_bot = mu * t - n, mu * n + t
    top = (c_on & (v_top <= 0), v_top, scale)
    bottom = (c_on & (v_bot <= 0), v_bot, scale)
    if ckeys is not None:
      k = cone_keys(lay, ckeys, rows.cpu().numpy())
      top, bottom = ((by_key(z[0], k, n_keys, False),
                      by_key(z[1], k, n_keys, float('inf')),
                      by_key(z[2], k, n_keys, float('inf')))
                     for z in (top, bottom))
    tops.append(top)
    bottoms.append(bottom)
  for q, parts in (('cone top', tops), ('cone bottom', bottoms)):
    if parts:
      out[q] = tuple(torch.cat(x, dim=1) for x in zip(*parts))
  if J.dtype == torch.float32:
    newton_x = (seen or {}).get('newton x')
    out['solve stop'] = solve_stop(m, lay, d,
                                   newton_x[0] if newton_x else None)
  return out


def first_differences(test, ref, lanes=None):
  """For each lane, where the discrete choices of run `test` first differ
  from those of run `ref` (lists of `branches` per acc stage, the same
  lanes; `lanes` of them, by default read off the records): None where
  they never do, else (stage, quantity, element, distance), distance being
  the largest |value| / (EPS32 * scale) of the reference run over that
  quantity's differing elements at that stage."""
  import torch
  B = lanes or next(v[1].shape[0] for b in ref for v in b.values())
  first = [None] * B
  for s, (bt, br) in enumerate(zip(test, ref)):
    for q in QUANTITIES:
      if q not in br:
        continue
      if bt[q][0].is_floating_point():     # directions
        cos = (bt[q][0] * br[q][0]).sum(-1)
        diff = cos < math.cos(NORMAL_ANGLE)
      else:
        diff = bt[q][0] != br[q][0]
      v, scale = br[q][1].double(), br[q][2].double()
      dist = torch.where(diff, v.abs() / (EPS32 * scale), 0.0).amax(dim=1)
      for lane in torch.nonzero(diff.any(dim=1)).flatten().tolist():
        if first[lane] is None:
          element = int(torch.nonzero(diff[lane])[0])
          first[lane] = (s, q, element, float(dist[lane]))
  return first


def stop_distances(test, lanes=None):
  """Each lane's largest `solve stop` over the acc stages of run `test`
  (its list of `branches`, of `lanes` lanes, by default read off the
  records), in EPS32 x scale; inf where a stage recorded none (no solve,
  or a float64 run)."""
  import torch
  B = lanes or next((v[1].shape[0] for b in test for v in b.values()), 0)
  worst = torch.zeros(B, dtype=torch.float64)
  for b in test:
    if 'solve stop' not in b:
      return torch.full((B,), float('inf'), dtype=torch.float64)
    _, value, scale = b['solve stop']
    value, scale = value.double().abs(), scale.double()
    dist = torch.where(value == 0, 0.0, value / (EPS32 * scale)).amax(dim=1)
    worst = torch.maximum(worst, dist)
  return worst


def lane_verdicts(err, first, band, stops=None):
  """Each lane's verdict from its largest scaled error `err` (B,), its
  `first_differences` entry and, where given, its `stop_distances` entry:
    'held'     err <= REF_TOL;
    'excused'  over REF_TOL, and either its first differing choice within
               `band` (x EPS32 x scale) of its threshold in the reference
               run, or every choice matched, every solve stopped within
               `band` of its float64 optimum's cost and err <= STOP_TOL;
    'failed'   any other lane over REF_TOL.
  """
  out = []
  for i, (e, f) in enumerate(zip(err.tolist(), first)):
    if e <= REF_TOL:
      out.append('held')
    elif f is not None:
      out.append('excused' if f[3] <= band else 'failed')
    elif stops is not None and stops[i] <= band and e <= STOP_TOL:
      out.append('excused')
    else:
      out.append('failed')
  return out


def lane_reason(first, stop):
  """What a lane over REF_TOL is judged by: its first differing choice
  (`first_differences`), or, where every choice matched, the largest
  distance its solves stopped at (`stop_distances`)."""
  if first is not None:
    return (f'first differing choice at stage {first[0]}: {first[1]} '
            f'element {first[2]}, float64 value {first[3]:.3g} x EPS32 x '
            f'scale from its threshold')
  return (f'every choice matched; solve stopped at {float(stop):.3g} x '
          f'EPS32 x scale from its float64 optimum\'s cost')


def gate_failures(run, plain):
  """What fails the reference gate for the `lane_verdicts` of a float32
  run of the step, given those of another float32 run of it on the same
  lanes (K1 as plain PyTorch): any failed lane; more than twice the lanes
  the plain run excuses, plus one.  Returns the failures' descriptions
  (none: passed)."""
  out = []
  if 'failed' in run:
    out.append(f'{run.count("failed")} lanes failed')
  n, n_plain = run.count('excused'), plain.count('excused')
  if n > 2 * n_plain + 1:
    out.append(f'{n} lanes excused, the plain run {n_plain}')
  return out


def reference_controls(gen, ref_gen, nu, lanes, dev):
  """Controls of the reference step's `lanes` lanes, uniform in [-1, 1]:
  the first 64 from `gen` (the lanes the gate held before it held more),
  the rest from `ref_gen`, so that `gen` makes the same draws as then."""
  import torch
  first = torch.rand((64, nu), generator=gen, device=dev) * 2 - 1
  rest = torch.rand((lanes - 64, nu), generator=ref_gen, device=dev) * 2 - 1
  return torch.cat([first, rest])


# K1's wrappers and the plain versions `plain_k1` sends them to
K1_PLAIN = {'cholesky_batched': 'cholesky_plain',
            'chol_solve_batched': 'chol_solve_plain',
            'cho_solve_batched': 'cho_solve_plain'}


@contextlib.contextmanager
def plain_k1(lk):
  """Inside, K1's wrappers (module `lk`) run their plain versions on any
  device: the float32 card path with K1 as plain PyTorch."""
  saved = {k: getattr(lk, k) for k in K1_PLAIN}
  for k, plain in K1_PLAIN.items():
    setattr(lk, k, getattr(lk, plain))
  try:
    yield
  finally:
    for k, fn in saved.items():
      setattr(lk, k, fn)


@contextlib.contextmanager
def plain_kernels(lk, nk):
  """Inside, K1's and the Newton solve's wrappers (modules `lk`, `nk`) run
  their plain versions on any device (`plain_k1`; the Newton solve's with
  the layout's row types and cones)."""
  solve = nk.newton_solve_batched

  def plain(*args, lay, **kw):
    return nk.newton_solve_plain(*args, types=lay.types,
                                 ell_groups=lay.ell_groups, **kw)

  nk.newton_solve_batched = plain
  try:
    with plain_k1(lk):
      yield
  finally:
    nk.newton_solve_batched = solve


def reference_gate(what, m, data, ctrl, n_sub, lk):
  """Phase reference for one task: one control step of the first
  ctrl.shape[0] lanes of `data` on the card at float32 (model m), through
  the K1 kernels and with K1 plain (`plain_k1`), each against the port's
  float64 path, run on the card through the plain versions of every
  kernel (`plain_kernels`: the CPU path's arithmetic), every run
  recording its discrete choices (`branches`); each lane's verdict
  (`lane_verdicts`; a lane that fails is judged again against the CPU's
  float64 run of it, `cpu_reference`), and the kernels' run held to the
  plain run's (`gate_failures`).  Returns the kernels' run's largest
  errors {qpos, qvel[, act]}."""
  import torch
  from dm_control_tpu_torch.ops import newton_kernel as nk
  lanes = slice(0, ctrl.shape[0])
  with plain_kernels(lk, nk):
    ref = one_step(m, data, lanes, ctrl, n_sub, torch.float64, ctrl.device,
                   record=True)
  ref.update({f: ref[f].cpu() for f in state_fields(m)})
  runs = {'kernels': one_step(m, data, lanes, ctrl, n_sub, torch.float32,
                              ctrl.device, record=True)}
  with plain_k1(lk):
    runs['plain'] = one_step(m, data, lanes, ctrl, n_sub, torch.float32,
                             ctrl.device, record=True)

  def judged(ref):
    out = {}
    for route, run in runs.items():
      errs = {f: scaled_err(run[f].cpu().double(), ref[f]).amax(dim=1)
              for f in state_fields(m)}
      err = torch.stack(list(errs.values())).amax(dim=0)
      first = first_differences(run['branches'], ref['branches'],
                                ctrl.shape[0])
      stops = stop_distances(run['branches'], ctrl.shape[0])
      out[route] = (errs, err, first, stops,
                    lane_verdicts(err, first, BAND, stops))
    return out

  by_route = judged(ref)
  failed = [i for i in range(ctrl.shape[0])
            if any(v[4][i] == 'failed' for v in by_route.values())]
  if failed:
    ref = cpu_reference(what, m, data, ctrl, n_sub, ref,
                        torch.tensor(failed))
    by_route = judged(ref)
  counts, largest, gated = {}, {}, {}
  for route, (errs, err, first, stops, verdicts) in by_route.items():
    gated[route] = verdicts
    counts[route] = {v: verdicts.count(v)
                     for v in ('held', 'excused', 'failed')}
    matched = torch.tensor([f is None for f in first])
    largest[route] = {f: e.max().item() for f, e in errs.items()}
    log(f'# phase reference: {what}, K1 {route}, {len(first)} lanes, float32 '
        f'card vs float64 (plain versions, on the card): max scaled err '
        + ' '.join(f'{f} {e:.2e}' for f, e in largest[route].items())
        + f'; lanes whose choices all '
        f'matched {int(matched.sum())}, their largest error '
        f'{err[matched].max().item() if matched.any() else 0:.2e}; '
        f'{counts[route]}')
    for lane in torch.nonzero(err > REF_TOL).flatten().tolist():
      log(f'#   {what}, K1 {route}: lane {lane} error {err[lane].item():.2e}'
          f' {verdicts[lane]}: {lane_reason(first[lane], stops[lane])}')
  failures = gate_failures(gated['kernels'], gated['plain'])
  assert not failures, f'{what} reference gate: {"; ".join(failures)}'
  return largest['kernels']


def cpu_reference(what, m, data, ctrl, n_sub, ref, idx):
  """The reference gate's float64 run `ref` (on the card, its fields and
  `branches` on the CPU) with lanes `idx` (a CPU index tensor) run again
  by the port's float64 path on the CPU, those lanes alone: the lanes a
  float32 run fails against the card's run are judged against the CPU's.
  The card's plain float64 Newton solve can depend on the batch (ROADMAP
  queue 3, item 8).  Logs each lane's distance between the two float64
  runs."""
  import torch
  at = idx.to(ctrl.device)
  cpu = one_step(m, data, at, ctrl[at], n_sub, torch.float64, 'cpu',
                 record=True)
  gap = torch.stack([scaled_err(cpu[f], ref[f][idx]).amax(dim=1)
                     for f in state_fields(m)]).amax(dim=0)
  out = dict(ref)
  for f in state_fields(m):
    out[f] = ref[f].clone()
    out[f][idx] = cpu[f]
  out['branches'] = []
  for b, b_cpu in zip(ref['branches'], cpu['branches'], strict=True):
    assert b.keys() == b_cpu.keys(), (what, b.keys(), b_cpu.keys())
    stage = {}
    for q, v in b.items():
      stage[q] = tuple(None if t is None else t.clone().index_put_(
          (idx,), t_cpu) for t, t_cpu in zip(v, b_cpu[q], strict=True))
    out['branches'].append(stage)
  log(f'# phase reference: {what}: lanes {idx.tolist()} failed, '
      f'float64 run again on the CPU, those lanes alone; its distance from '
      f'the card\'s float64 run (max scaled err of '
      f'{"/".join(state_fields(m))}) {[float(f"{g:.3g}") for g in gap]}')
  return out


# escape's rangefinder observation on the card against the float64 CPU
# path from the same state: tanh of a distance whose heightfield ray ends
# in a 12-step bisection of a 1.36 m march step (to 3.3e-4 m)
RF_TOL = 2e-3


def rangefinder_check(m, m_cpu, data):
  """escape's rangefinder observation (tanh of each rangefinder's
  distance, 1 where its ray hits nothing) of the first REF_LANES lanes of
  `data`, from kinematics and the posvel sensors on the card at float32
  and on the CPU at float64 from the same state: each lane's largest
  difference within RF_TOL, or each of its rays over RF_TOL one whose
  float64 heightfield march had a sample within BAND x EPS32 x max(1, |z|
  + |h|) of the surface (`render.hfield_march`), which float32 rounding
  can put on the other side and so start the bisection a march step
  away."""
  import numpy as np
  import torch
  from dm_control_tpu_torch._src import forward
  from dm_control_tpu_torch._src import render
  from dm_control_tpu_torch._src import sensor
  from dm_control_tpu_torch._src import smooth
  from dm_control_tpu_torch._src.types import SensorType
  rf = [s for s in range(m.nsensor)
        if SensorType(int(m.sensor_type[s])) == SensorType.RANGEFINDER]
  cols = [int(m.sensor_adr[s]) for s in rf]
  sites = [int(m.sensor_objid[s]) for s in rf]
  lanes = slice(0, REF_LANES)

  def run(mm, dtype, dev):
    small = forward.map_state(
        lambda x: x[lanes].to(dev, dtype) if x.is_floating_point()
        else x[lanes].to(dev), forward.state_of(data))
    d = smooth.kinematics(mm, forward.make_data(mm, REF_LANES, dtype,
                                                dev).replace(**small))
    r = sensor.sensors(mm, d, 'posvel').sensordata[:, cols]
    return torch.where(r == -1.0, 1.0, torch.tanh(r)), d

  out, _ = run(m, torch.float32, data.qpos.device)
  ref, d64 = run(m_cpu, torch.float64, 'cpu')
  diff = (out.cpu().double() - ref).abs()
  g = m.name2id('geom', 'terrain')
  h_pos, h_mat = d64.geom_xpos[:, g], d64.geom_xmat[:, g]
  ol = torch.einsum('BSi,Bij->BSj', d64.site_xpos[:, sites] - h_pos[:, None],
                    h_mat)
  dl = torch.einsum('BSi,Bij->BSj', d64.site_xmat[:, sites][..., :, 2], h_mat)
  _, z, h, _ = render.hfield_march(m_cpu, d64, int(m.geom_dataid[g]), ol, dl)
  near = ((z - h).abs() / (EPS32 * (z.abs() + h.abs()).clamp(min=1.0))
          <= BAND).any(-1)
  over = diff > RF_TOL
  failed = (over & ~near).any(-1)
  log(f'# phase reference: quadruped-escape rangefinder, {REF_LANES} lanes x '
      f'{len(rf)} rays, float32 card vs float64 CPU from the same state: '
      f'max |obs difference| {diff.max().item():.2e}; rays over RF_TOL '
      f'{int(over.sum())} (their march within the band of the surface '
      f'{int((over & near).sum())}); rays that hit nothing '
      f'{int((ref == 1.0).sum())}')
  for lane in np.flatnonzero(failed.numpy()).tolist():
    log(f'#   quadruped-escape rangefinder lane {lane}: differences '
        f'{diff[lane].tolist()}')
  assert not bool(failed.any()), (
      f'escape rangefinder: {int(failed.sum())} lanes over RF_TOL')


def finger_solver_inputs(m, lay, B, gen, dev):
  """finger-spin solver inputs for B lanes in contact, float32 on dev.

  Joint angles are drawn by the port's randomizer and kept where
  `has_contacts` is true (~9% of draws); the joint velocities are
  N(0, 2^2) so that contacts slide, the controls uniform.  The pipeline
  then runs up to the solve.  Returns (solver args, the forward Data)."""
  import torch
  from dm_control_tpu_torch._src import forward
  from dm_control_tpu_torch.suite import base
  kept = []
  while sum(len(q) for q in kept) < B:
    d = forward.make_data(m, 8 * B, torch.float32, dev)
    q = base.randomize_limited_and_rotational_joints(m, d.qpos, gen)
    kept.append(q[base.has_contacts(m, d.replace(qpos=q))])
  q = torch.cat(kept)[:B]
  v = 2 * torch.randn((B, m.nv), generator=gen, device=dev)
  u = 2 * torch.rand((B, m.nu), generator=gen, device=dev) - 1
  d = forward.make_data(m, B, torch.float32, dev).replace(qpos=q, qvel=v,
                                                          ctrl=u)
  d = forward.step1(m, d, skipsensor=True)
  d = forward.actuation(m, d)
  d = forward.fwd_acceleration(m, d)
  args = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
          d.efc_active.to(torch.float32), d.qacc_smooth, d.qacc_smooth)
  return args, d


def slice_steps(what):
  """The control steps of each of slice task `what`'s runs."""
  if what in SLICE12_TASKS:
    return SLICE12_STEPS
  if what in SLICE11_TASKS:
    return SLICE11_STEPS[what]
  if what in SLICE10_TASKS:
    return SLICE10_STEPS
  return (SLICE9_STEPS if what in SLICE9_TASKS + STACKER_TASKS
          else SLICE_STEPS)


def slice_run(env, i_task, run, dev, after_reset=lambda: None):
  """Run `run` of slice task number `i_task` (in SLICE_TASKS, then
  STACKER_TASKS for tools/k1_reference_step.py): env.reset(
  seed=run), after_reset(), then `slice_steps` control steps through
  `rollout_fn` with actions from a generator of its own.  Returns (state,
  rewards, seconds of the reset, seconds of the steps), each ended by a
  synchronize."""
  import torch
  gen = torch.Generator(device=dev)
  gen.manual_seed(SLICE_SEED + 100 * (i_task + 1) + run)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  state = env.reset(seed=run)
  torch.cuda.synchronize()
  t_reset = time.perf_counter() - t0
  after_reset()
  t0 = time.perf_counter()
  what = (SLICE_TASKS + STACKER_TASKS)[i_task]
  state, rewards = env.rollout_fn(slice_steps(what))(state, gen)
  torch.cuda.synchronize()
  return state, rewards, t_reset, time.perf_counter() - t0


def row_key(what):
  """The key of task `what`'s entry in a kernel's row of the `kernels`
  line: its domain, or the whole task name where its domain has several
  entries (the ninth slice's and the tenth's; the cone model's layouts
  are 'cones x1' and 'cones x2')."""
  if what in SLICE9_K1 + SLICE10_TASKS + SLICE12_TASKS:
    return what
  return what.split('-')[0]


def slice_controls(i_task, nu, lanes, dev):
  """The reference step's controls of slice task number `i_task`, uniform
  in [-1, 1], from a generator of its own."""
  import torch
  gen = torch.Generator(device=dev)
  gen.manual_seed(SLICE_SEED + 1 + i_task)
  return torch.rand((lanes, nu), generator=gen, device=dev) * 2 - 1


def impact_states(what, m, B, gen, dev):
  """B states of `what` at their first impacts (or limits), float32 on
  dev, drawn from `gen`: cheetahs low enough that their feet or legs touch
  the floor, near upright, with random joint velocities; carts at the
  slider's limit (within 2 cm either side of it) moving into it, poles at
  any angle; point masses at a wall (within 1 cm either side) moving into
  it; ball_in_cup's balls by turns in the cup, below it with the string
  about taut, and on the floor under a lowered cup; swimmers with their
  first joint at its limit (within 0.01 either side) moving into it, the
  rest of the chain anywhere in range, slow; humanoids lying on the floor
  (the root 0.1 to 0.4 up) and quadrupeds standing or fallen (0.15 to
  0.6), at random orientations, every hinge anywhere in range, slow;
  manipulators and stackers with their props on the floor, stacked or in
  the slot (`prop_states`); the tenth slice's bodies as humanoid's and
  quadruped's, escape's on a terrain of each lane's own (`model_var`), at
  the bowl's middle or up to 6 m out on its slope, over the terrain there,
  and fetch's ball on the floor by the body or against a wall
  (`ball_states`); dogs standing or lying, fetch's ball beside the head,
  in the mouth, on the target or over the body (`dog_states`).  Controls
  uniform."""
  import math as pymath
  import torch
  from dm_control_tpu_torch._src import forward
  kw = dict(generator=gen, device=dev)
  u = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(shape or (B,), **kw)
  adr = lambda name: int(m.jnt_qposadr[m.name2id('joint', name)])
  d = forward.make_data(m, B, torch.float32, dev)
  qpos = d.qpos.clone()
  if what == 'cheetah-run':
    for j in range(m.njnt):
      lo, hi = m.jnt_range[j] if m.jnt_limited[j] else (-pymath.pi, pymath.pi)
      qpos[:, int(m.jnt_qposadr[j])] = u(float(lo), float(hi))
    qpos[:, adr('rootx')] = 0.0
    qpos[:, adr('rootz')] = u(-0.3, -0.05)
    qpos[:, adr('rooty')] = u(-0.5, 0.5)
    qvel = torch.randn((B, m.nv), **kw)
  elif what == 'cartpole-swingup':
    side = torch.where(torch.rand(B, **kw) < 0.5, -1.0, 1.0)
    qpos[:, adr('slider')] = side * u(1.78, 1.82)
    qpos[:, adr('hinge_1')] = u(-pymath.pi, pymath.pi)
    qvel = torch.randn((B, m.nv), **kw)
    qvel[:, 0] = side * u(0.0, 3.0)
  elif what == 'point_mass-easy':
    side = torch.where(torch.rand(B, **kw) < 0.5, -1.0, 1.0)
    qpos[:, adr('root_x')] = side * u(0.28, 0.30)
    qpos[:, adr('root_y')] = u(-0.29, 0.29)
    qvel = 0.5 * torch.randn((B, m.nv), **kw)
    qvel[:, 0] = side * u(0.0, 1.0)
  elif what == 'ball_in_cup-catch':
    kind = torch.arange(B, device=dev) % 3
    cup_x, cup_z = u(-0.05, 0.05), u(-0.05, 0.05)
    cup_z = torch.where(kind == 2, -0.45, cup_z)
    qpos[:, adr('cup_x')], qpos[:, adr('cup_z')] = cup_x, cup_z
    qpos[:, adr('ball_x')] = cup_x + u(-0.03, 0.03)
    qpos[:, adr('ball_z')] = torch.where(
        kind == 0, cup_z + 0.2675,
        torch.where(kind == 1, u(-0.015, 0.0), -0.176))
    qvel = 0.3 * torch.randn((B, m.nv), **kw)
  elif what in SLICE9_TASKS + STACKER_TASKS:
    qpos, qvel = prop_states(m, qpos, gen)
  elif what in SLICE10_TASKS:
    from dm_control_tpu_torch._src import colliders
    from dm_control_tpu_torch._src.types import JointType
    from dm_control_tpu_torch.suite import quadruped
    for j in range(m.njnt):
      if m.jnt_type[j] == JointType.HINGE:
        qpos[:, int(m.jnt_qposadr[j])] = u(*(float(v)
                                             for v in m.jnt_range[j]))
    quat = torch.randn((B, 4), **kw)
    qpos[:, 3:7] = quat / quat.norm(dim=1, keepdim=True)
    qpos[:, :2] = 0.0
    qpos[:, 2] = (u(0.1, 0.4) if what == 'humanoid_CMU-run'
                  else u(0.15, 0.6))
    if what == 'quadruped-escape':
      d = d.replace(model_var={'hfield_data': quadruped.terrain(m, gen,
                                                                qpos)})
      ang, r = u(-pymath.pi, pymath.pi), u(0.0, 6.0)
      qpos[:, 0], qpos[:, 1] = r * torch.cos(ang), r * torch.sin(ang)
      g = m.name2id('geom', 'terrain')
      h = colliders.hfield_height(m, d, int(m.geom_dataid[g]),
                                  qpos[:, None, :2])[0][:, 0]
      qpos[:, 2] += (h + float(m.geom_pos[g, 2])).clamp(min=0.0)
    if what == 'quadruped-fetch':
      ball_states(m, qpos, gen)
    qvel = 0.3 * torch.randn((B, m.nv), **kw)
  elif what == 'jaco-position_reacher_7DOF':
    qpos, qvel, d = jaco_states(m, d, gen)
  elif what in SLICE12_TASKS:
    qpos, qvel = dog_states(m, qpos, gen)
  elif what in SLICE8_TASKS:
    for j in range(1, m.njnt):
      qpos[:, int(m.jnt_qposadr[j])] = u(*(float(v) for v in m.jnt_range[j]))
    quat = torch.randn((B, 4), **kw)
    qpos[:, 3:7] = quat / quat.norm(dim=1, keepdim=True)
    qpos[:, :2] = 0.0
    qpos[:, 2] = (u(0.1, 0.4) if what == 'humanoid-run' else u(0.15, 0.6))
    qvel = 0.3 * torch.randn((B, m.nv), **kw)
  else:
    for j in range(m.njnt):
      lo, hi = m.jnt_range[j] if m.jnt_limited[j] else (-pymath.pi, pymath.pi)
      qpos[:, int(m.jnt_qposadr[j])] = u(float(lo), float(hi))
    side = torch.where(torch.rand(B, **kw) < 0.5, -1.0, 1.0)
    limit = float(m.jnt_range[m.name2id('joint', 'joint_0'), 1])
    qpos[:, adr('joint_0')] = side * (limit + u(-0.01, 0.01))
    qvel = 0.3 * torch.randn((B, m.nv), **kw)
    qvel[:, int(m.jnt_dofadr[m.name2id('joint', 'joint_0')])] = side
  ctrl = u(-1.0, 1.0, B, m.nu)
  return d.replace(qpos=qpos, qvel=qvel, ctrl=ctrl)


def dog_states(m, qpos, gen):
  """qpos and qvel of dog lanes (qpos: the model's qpos0 per lane, on the
  card), drawn from `gen`: on even lanes standing at qpos0, every hinge
  within 0.3 of it, at a random yaw, the feet 0 to 3 cm into the floor; on
  odd lanes lying, the root 0.15 to 0.3 m up at a random orientation; each
  0.6 to 1 m from the origin (off fetch's target, which the JAX package's
  cylinder-box collider takes for a sphere of its radius: a hand on it
  diverges there as here).  fetch's ball, still: on the floor beside the
  head (lanes 0 mod 4), in the mouth between the bite sites (1 mod 4), on
  the target (2 mod 4) or over the body (3 mod 4).  Slow joint
  velocities.  (tests/test_torch_dog.dog_states draws the same with
  numpy.)"""
  import math as pymath
  import torch
  from dm_control_tpu_torch._src import forward
  from dm_control_tpu_torch._src import smooth
  from dm_control_tpu_torch._src.types import JointType
  B, dev = qpos.shape[0], qpos.device
  kw = dict(generator=gen, device=dev)
  u = lambda lo, hi, *shape: lo + (hi - lo) * torch.rand(shape or (B,), **kw)
  qpos = qpos.clone()
  lane = torch.arange(B, device=dev)
  even = lane % 2 == 0
  for j in range(m.njnt):
    if m.jnt_type[j] == JointType.HINGE:
      q = int(m.jnt_qposadr[j])
      qpos[:, q] = (qpos[:, q] + u(-0.3, 0.3)).clamp(
          *(float(v) for v in m.jnt_range[j]))
  root = int(m.jnt_qposadr[m.name2id('joint', 'root')])
  yaw = u(-pymath.pi, pymath.pi)
  quat = torch.randn((B, 4), **kw)
  zero = torch.zeros_like(yaw)
  qpos[:, root + 3:root + 7] = torch.where(
      even[:, None], torch.stack([torch.cos(yaw / 2), zero, zero,
                                  torch.sin(yaw / 2)], -1),
      quat / quat.norm(dim=1, keepdim=True))
  away, r = u(-pymath.pi, pymath.pi), u(0.6, 1.0)
  qpos[:, root], qpos[:, root + 1] = r * torch.cos(away), r * torch.sin(away)
  qpos[:, root + 2] = torch.where(
      even, float(m.qpos0[root + 2]) - u(0.0, 0.03), u(0.15, 0.3))
  qvel = 0.3 * torch.randn((B, m.nv), **kw)
  if 'ball_root' in m.names['joint']:
    kin = smooth.kinematics(m, forward.make_data(
        m, B, qpos.dtype, dev).replace(qpos=qpos))
    head = kin.site_xpos[:, m.name2id('site', 'head')]
    mouth = 0.5 * (kin.site_xpos[:, m.name2id('site', 'upper_bite')]
                   + kin.site_xpos[:, m.name2id('site', 'lower_bite')])
    torso = kin.xpos[:, m.name2id('body', 'torso')]
    rad = float(m.geom_size[m.name2id('geom', 'ball'), 0])
    ang = u(-pymath.pi, pymath.pi)
    beside = torch.stack([head[:, 0] + 0.15 * torch.cos(ang),
                          head[:, 1] + 0.15 * torch.sin(ang),
                          rad - u(0.0, 1e-3)], -1)
    on_target = torch.stack([u(-0.05, 0.05), u(-0.05, 0.05),
                             0.004 + rad - u(0.0, 1e-3)], -1)
    over = torso + torch.tensor([0.0, 0.0, 0.3], device=dev)
    kind = (lane % 4)[:, None]
    ball = int(m.jnt_qposadr[m.name2id('joint', 'ball_root')])
    qpos[:, ball:ball + 3] = torch.where(
        kind == 0, beside, torch.where(kind == 1, mouth, torch.where(
            kind == 2, on_target, over)))
    qpos[:, ball + 3:ball + 7] = torch.tensor([1.0, 0.0, 0.0, 0.0],
                                              device=dev)
    bd = int(m.jnt_dofadr[m.name2id('joint', 'ball_root')])
    qvel[:, bd:bd + 6] = 0.0
  return qpos, qvel


def jaco_states(m, d, gen):
  """jaco's impact states on d's lanes, drawn from `gen`: the arm within
  0.3 of the home pose, each finger joint anywhere in its range or, on one
  lane of four, at its lower limit, slow; the target sphere (a per-lane
  `geom_pos`, `model_var`) on half the lanes within 3 cm of one link's
  frame (a sphere-mesh contact, or its center inside the hull), far from
  the arm on the others.  Returns (qpos, qvel, d with the targets)."""
  import numpy as np
  import torch
  from dm_control_tpu_torch._src import smooth
  from dm_control_tpu_torch._src.types import mirror
  from dm_control_tpu_torch.suite import jaco
  B, dev = d.qpos.shape[0], d.qpos.device
  kw = dict(generator=gen, device=dev)
  qpos = d.qpos.clone()
  qpos[:, :13] = mirror(m, qpos, jaco._HOME_ANGLES)
  qpos[:, :7] += 0.3 * (2 * torch.rand((B, 7), **kw) - 1)
  lo = mirror(m, qpos, m.jnt_range[7:13, 0])
  hi = mirror(m, qpos, m.jnt_range[7:13, 1])
  fingers = lo + (hi - lo) * torch.rand((B, 6), **kw)
  at_limit = (torch.arange(B, device=dev) % 4 == 0)[:, None]
  qpos[:, 7:13] = torch.where(at_limit, lo, fingers)
  qvel = 0.3 * torch.randn((B, m.nv), **kw)
  links = np.array([m.name2id('geom', f'jaco_link_{i}') for i in range(1, 8)]
                   + [m.name2id('geom', f'jaco_link_finger_tip_{i}')
                      for i in (1, 2, 3)])
  kin = smooth.kinematics(m, d.replace(qpos=qpos))
  pick = torch.randint(0, len(links), (B,), **kw)
  near = kin.geom_xpos[torch.arange(B, device=dev),
                       mirror(m, qpos, links)[pick]]
  near = near + 0.03 * (2 * torch.rand((B, 3), **kw) - 1)
  far = mirror(m, qpos, np.array([0.6, 0.6, 0.6])).expand(B, 3)
  target = torch.where((torch.arange(B, device=dev) % 2 == 0)[:, None],
                       near, far)
  geom_pos = mirror(m, qpos, m.geom_pos).expand(B, m.ngeom, 3).clone()
  geom_pos[:, m.name2id('geom', 'target')] = target
  mv = {'geom_pos': geom_pos, '_jaco_penalty': qpos.new_zeros(B)}
  return qpos, qvel, d.replace(model_var=mv)


def ball_states(m, qpos, gen):
  """fetch's ball in qpos (B, nq) on the card, in place, drawn from `gen`:
  upright, on the floor 0 to 1 mm deep, beside the body (0.45 m from the
  root, even lanes) or against the wall at x = -15.7, tilted 45 degrees
  (odd lanes).  (tests/test_torch_domains.ball_states draws the same with
  numpy.)"""
  import math as pymath
  import torch
  B, dev = qpos.shape[0], qpos.device
  u = lambda lo, hi: lo + (hi - lo) * torch.rand(B, generator=gen,
                                                 device=dev)
  q = int(m.jnt_qposadr[m.name2id('joint', 'ball_root')])
  r = float(m.geom_size[m.name2id('geom', 'ball'), 0])
  wall = m.name2id('geom', 'wall_px')
  z = r - u(0.0, 1e-3)
  ang = u(-pymath.pi, pymath.pi)
  x_wall = ((r - u(0.0, 1e-3)) * pymath.sqrt(2) + float(m.geom_pos[wall, 0])
            - (z - float(m.geom_pos[wall, 2])))
  even = torch.arange(B, device=dev) % 2 == 0
  qpos[:, q] = torch.where(even, qpos[:, 0] + 0.45 * torch.cos(ang), x_wall)
  qpos[:, q + 1] = torch.where(even, qpos[:, 1] + 0.45 * torch.sin(ang),
                               u(-5.0, 5.0))
  qpos[:, q + 2] = z
  qpos[:, q + 3:q + 7] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)


def prop_states(m, qpos, gen):
  """qpos and qvel of manipulator or stacker lanes (qpos: the model's
  qpos0 per lane, on the card), drawn from `gen`: the arm anywhere in
  range, slow, and on two lanes of three the props in contact: the ball on
  the floor; the peg standing on its tip, or by turns in its slot (at the
  model's slot pose); box 0 on the floor, box 1 on box 0 and boxes 2 and 3
  on the floor beside them, each turned by up to 0.05 or, on every fourth
  lane, exactly flat (corners and faces tied).  The other lanes' props
  anywhere in the air.  (tests/test_torch_domains.prop_states draws the
  same with numpy.)"""
  import math as pymath
  import torch
  from dm_control_tpu_torch.suite import manipulator
  B, dev = qpos.shape[0], qpos.device
  kw = dict(generator=gen, device=dev)
  u = lambda lo, hi: lo + (hi - lo) * torch.rand(B, **kw)
  adr = lambda name: int(m.jnt_qposadr[m.name2id('joint', name)])
  qpos = manipulator.Arm(m).sample(qpos, gen)
  lane = torch.arange(B, device=dev)
  in_contact = lane % 3 < 2
  sink = u(0.0, 1e-3)
  tilt = torch.where(lane % 4 == 0, 0.0, u(-0.05, 0.05))
  names = m.names['joint']
  if 'ball_x' in names:
    qpos[:, adr('ball_x')] = u(-0.3, 0.3)
    qpos[:, adr('ball_z')] = torch.where(in_contact, 0.022 - sink,
                                         u(0.1, 0.5))
  if 'peg_x' in names:
    x, z, angle = u(-0.3, 0.3), 0.118 - sink, tilt
    if 'slot_0' in m.names['geom']:
      b = m.name2id('body', 'slot')
      into = lane % 3 == 1
      x = torch.where(into, float(m.body_pos[b, 0]) + u(-1e-3, 1e-3), x)
      z = torch.where(into, float(m.body_pos[b, 2]) + u(-1e-3, 1e-3), z)
      angle = torch.where(into, 2 * pymath.atan2(float(m.body_quat[b, 2]),
                                                 float(m.body_quat[b, 0])),
                          angle)
    qpos[:, adr('peg_x')] = x
    qpos[:, adr('peg_z')] = torch.where(in_contact, z, u(0.2, 0.5))
    qpos[:, adr('peg_y')] = angle
  for i, x0 in enumerate((0.1, 0.1, -0.1, 0.25)):
    if f'box{i}_x' not in names:
      break
    qpos[:, adr(f'box{i}_x')] = x0 + u(-0.01, 0.01)
    qpos[:, adr(f'box{i}_z')] = torch.where(
        in_contact, (0.066 - 2 * sink) if i == 1 else (0.022 - sink),
        u(0.1, 0.6))
    qpos[:, adr(f'box{i}_y')] = tilt * (1 - 2 * (i % 2))
  return qpos, 0.3 * torch.randn((B, m.nv), **kw)


def k2_task_check(nk, what, m, lay, d, gates=None):
  """K2 on `what`'s solver inputs from the states d (the pipeline run up
  to the solve, warm-started from d's qacc_warmstart), at least a quarter
  of whose lanes must touch (an active contact row, or any active row
  where the model has no contacts): against the plain float32 solve and
  against the plain float64 optimum of the same inputs, at the model's
  own tolerance, with the bounds of tests/test_pallas.py (mean <= 1e-4,
  max <= 5e-2, <= 10% of lanes above 1e-3) on the lane-scaled error
  (`k2_check`); the launch configuration; the first B - 3 lanes alone
  and a second launch giving the full batch's bits.  The component-scaled
  readings are printed for the record: on walker's first floor impacts
  they fail 5e-2 for the plain float32 solve itself against float64, so
  they measure float32, not the kernel.  On an elliptic layout the
  solve is K2-ell, held by `ell_gates` (its plain versions with the
  layout's cones), or by `gates` where given (`stop_gates`, called with
  the layout and the solver inputs too), and
  the lanes' active elliptic contacts and their zones at the float64
  optimum are printed.  Returns (args, kw, iterations, max |kernel -
  plain|, the forward Data, {k: (B,)} each lane's active elliptic
  contacts of k rows (`cone_counts`) or None)."""
  import torch
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src import forward
  from dm_control_tpu_torch._src import solver
  d = forward.step1(m, d, skipsensor=True)
  d = forward.actuation(m, d)
  d = forward.fwd_acceleration(m, d)
  args = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
          d.efc_active.to(torch.float32), d.qacc_smooth, d.qacc_warmstart)
  kw = dict(niter=int(m.opt.iterations), ls_iter=solver.LS_ITERATIONS,
            tol=solver.effective_tol(m.opt.tolerance, torch.float32),
            meaninertia=float(m.stat_meaninertia))
  B = args[0].shape[0]
  name = 'newton_solve_ell' if lay.ell_groups else 'newton_solve_batched'
  x_k, f_k, iters = nk.newton_solve_batched(*args, lay=lay,
                                            return_iters=True, **kw)
  plain_kw = dict(types=lay.types, ell_groups=lay.ell_groups)
  x_p, _, iters_p = nk.newton_solve_plain(*args, **plain_kw,
                                          return_iters=True, **kw)
  x_64, _ = nk.newton_solve_plain(
      *[a.double() for a in args], **plain_kw,
      **dict(kw, tol=solver.effective_tol(m.opt.tolerance, torch.float64)))
  # the rows after the equalities (always active), friction losses and
  # joint limits
  first = (int((lay.types == efc.EQUALITY).sum()) + len(lay.fric_dof)
           + len(lay.lim_jnt))
  touch = d.efc_active[:, first:] if lay.nefc > first else d.efc_active
  active = int(touch.any(dim=1).sum())
  cones = None
  if lay.ell_groups:
    on, zones = cone_zones(lay, args[0].double(), args[2].double(), args[5],
                           x_64)
    count = on.sum(dim=1)
    cones = cone_counts(lay, on)
    extra = (f'; active elliptic contacts mean '
             f'{count.double().mean().item():.2f} max {int(count.max())} '
             f'of ncg={n_cones(lay)} per lane, zones at the '
             f'float64 optimum top {zones["top"]:.4f} bottom '
             f'{zones["bottom"]:.4f} mid {zones["mid"]:.4f}')
  log(f'# phase kernels: {name} on {what} B={B} '
      f'nefc={lay.nefc} nv={m.nv}: lanes in contact (or, without contacts, '
      f'with an active row) {active}; iterations mean '
      f'{iters.float().mean().item():.2f} max {int(iters.max())} (plain '
      f'float32: mean {iters_p.float().mean().item():.2f} max '
      f'{int(iters_p.max())})' + (extra if cones is not None else ''))
  assert active >= B // 4, f'{name} on {what}: too few lanes in contact'
  assert torch.isfinite(f_k).all() and torch.isfinite(x_k).all()
  if gates is not None:
    gates(f'{"K2-ell" if lay.ell_groups else "K2"} on {what}', x_k, x_p,
          x_64, lay, args)
  elif lay.ell_groups:
    ell_gates(f'K2-ell on {what}', x_k, x_p, x_64)
  else:
    k2_check(f'K2 on {what} kernel vs plain float32', x_k, x_p, gate=True)
    k2_check(f'K2 on {what} kernel vs plain float64', x_k.double(), x_64,
             gate=True)
    k2_check(f'K2 on {what} plain float32 vs plain float64', x_p.double(),
             x_64, gate=False)
  newton_launch(nk, f'{name} on {what}', lay, m.nv, B)
  newton_bits(nk, f'{name} on {what}', args, lay, kw, (x_k, f_k, iters))
  return args, kw, iters, (x_k - x_p).abs().max().item(), d, cones


def plain64(nk, args, lay, **kw):
  """The plain float64 solve (keyword arguments `kw`) of float32 solver
  inputs `args`, CHUNK lanes at a time (each lane's solve is its own): x
  (B, nv)."""
  import torch
  return torch.cat([nk.newton_solve_plain(
      *[a[i:i + CHUNK].double() for a in args], types=lay.types,
      ell_groups=lay.ell_groups, **kw)[0]
      for i in range(0, args[0].shape[0], CHUNK)])


def core_task_check(nk, lk, what, m, lay, d):
  """The route past the Newton kernel's dofs (`newton_kernel.
  newton_solve_core`: the JAX package's XLA core, with K1b as each
  iteration's factor-and-solve) on `what`'s solver inputs from the
  states d (the pipeline up to the solve, as `k2_task_check` makes them),
  at least a quarter of whose lanes must touch: K1b launched exactly once
  per iteration of the batch loop the core reports, no Newton kernel;
  held converged by `stop_gates` against the plain float32 core
  (`newton_solve_plain`, K1b's plain twin inside) and the plain float64
  one at the model's own tolerance (float64 CHUNK lanes at a time), and
  after one Newton iteration, without a line search and with one step
  (on the lanes where float64 moves alpha off 1), by `float32_gates`.
  Returns (args, kw, iterations, max |core - plain|, the forward Data,
  the loop's iterations)."""
  import torch
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src import forward
  from dm_control_tpu_torch._src import solver
  d = forward.step1(m, d, skipsensor=True)
  d = forward.actuation(m, d)
  d = forward.fwd_acceleration(m, d)
  args = (d.efc_J, d.qM, d.efc_aref, d.efc_D, d.efc_frictionloss,
          d.efc_active.to(torch.float32), d.qacc_smooth, d.qacc_warmstart)
  kw = dict(niter=int(m.opt.iterations), ls_iter=solver.LS_ITERATIONS,
            tol=solver.effective_tol(m.opt.tolerance, torch.float32),
            meaninertia=float(m.stat_meaninertia))
  B = args[0].shape[0]
  assert m.nv > nk.MAX_NV
  lk.reset_launches()
  nk.reset_launches()
  x_k, f_k, iters = nk.newton_solve_core(*args, lay=lay, return_iters=True,
                                         **kw)
  torch.cuda.synchronize()
  loops = nk.CORE_LOOPS['loops']
  launches = dict(lk.LAUNCHES, **nk.LAUNCHES)
  assert launches == {'cholesky_batched': 0, 'chol_solve_batched': loops,
                      'cho_solve_batched': 0, 'newton_solve_batched': 0,
                      'newton_solve_ell': 0}, launches
  assert loops == int(iters.max()) and nk.CORE_LOOPS['calls'] == 1
  x_p, _, iters_p = nk.newton_solve_plain(
      *args, types=lay.types, ell_groups=lay.ell_groups, return_iters=True,
      **kw)
  tol64 = solver.effective_tol(m.opt.tolerance, torch.float64)
  x_64 = plain64(nk, args, lay, **dict(kw, tol=tol64))
  first = (int((lay.types == efc.EQUALITY).sum()) + len(lay.fric_dof)
           + len(lay.lim_jnt))
  active = int(d.efc_active[:, first:].any(dim=1).sum())
  log(f'# phase kernels: core (K1b inside) on {what} B={B} nefc={lay.nefc} '
      f'nv={m.nv}: lanes in contact {active}; K1b launches {loops} (the '
      f'loop\'s iterations); iterations mean {iters.float().mean().item():.2f}'
      f' max {int(iters.max())} (plain float32: mean '
      f'{iters_p.float().mean().item():.2f} max {int(iters_p.max())})')
  assert active >= B // 4, f'core on {what}: too few lanes in contact'
  assert torch.isfinite(f_k).all() and torch.isfinite(x_k).all()
  stop_gates(f'core on {what}', x_k, x_p, x_64, lay, args)
  one = {}
  for ls in (0, 1):
    kw1 = dict(kw, niter=1, ls_iter=ls)
    one[ls] = (nk.newton_solve_core(*args, lay=lay, **kw1)[0],
               nk.newton_solve_plain(*args, types=lay.types, **kw1)[0],
               plain64(nk, args, lay, **dict(kw1, tol=tol64)))
  off = lane_scaled_err(one[1][2], one[0][2]).amax(dim=1) > 1e-3
  log(f'# phase kernels: core on {what}, one Newton iteration: lanes whose '
      f'one line-search step moves alpha off 1 '
      f'{float(off.double().mean()):.4f}')
  float32_gates(f'core on {what}, one iteration, no line search,', *one[0])
  float32_gates(f'core on {what}, one iteration, one line-search step, '
                f'alpha off 1,', *(x[off] for x in one[1]))
  return args, kw, iters, (x_k - x_p).abs().max().item(), d, loops


def topk_live(what, m, d):
  """Print, for each dynamic (top-K) group, the share of lanes on which it
  selected a live pair (an active contact) in d; humanoid's every group
  and quadruped's floor group must on some lane."""
  from dm_control_tpu_torch._src import collision
  con = d.contact
  on = con.dist < con.includemargin
  slot, shares = 0, {}
  for g in collision.groups(m):
    if g.dynamic:
      share = on[:, slot:slot + g.ncon].any(dim=1).double().mean().item()
      shares[f'{g.t1.name}-{g.t2.name}'] = share
      if what == 'humanoid-run' or g.t1 == 0:
        assert share > 0, f'{what}: no live pair in {g.t1.name}-{g.t2.name}'
    slot += g.ncon
  log(f'# phase kernels: {what}: lanes whose top-K groups select a live '
      f'pair {shares}')


def broadphase_bits(what, m, d):
  """The top-K selection and every contact field it gathers, for the
  first B - 3 lanes alone (kinematics included) and for a second call,
  must equal the full batch's bit for bit."""
  import torch
  from dm_control_tpu_torch._src import collision
  from dm_control_tpu_torch._src import smooth
  n = d.qpos.shape[0] - 3

  def contacts(dd):
    return collision.collide(m, smooth.kinematics(m, dd)).contact

  full, again = contacts(d), contacts(d)
  part = contacts(d.replace(
      model_var={k: v[:n] for k, v in (d.model_var or {}).items()},
      **{f: getattr(d, f)[:n] for f in ('qpos', 'qvel', 'ctrl')}))
  for f in ('dist', 'pos', 'frame', 'includemargin', 'friction', 'solref',
            'solimp', 'geom1', 'geom2', 'body1', 'body2', 'dim'):
    x = getattr(full, f)
    assert torch.equal(x, getattr(again, f)), f'{what}: two calls differ in {f}'
    assert torch.equal(x[:n], getattr(part, f)), (
        f'{what}: {n} lanes alone differ in {f}')
  log(f'# phase kernels: {what} broadphase: the first {n} lanes alone and '
      f'a second call give the full batch\'s selection and contacts bit for '
      f'bit')


def k2_bytes(B, nefc, nv):
  """Bytes the Newton solve must move: J, M, the four row vectors, a,
  warm, x and the forces, each once at float32."""
  return B * 4 * (nefc * nv + nv * nv + 4 * nefc + 2 * nv + nv + nefc)


def cone_zones(lay, J, aref, active, x, condim=None):
  """Active elliptic contacts at the solution x (every condim in condim
  order, or those of `condim`), and the shares of them in the top, bottom
  and middle zones."""
  import torch
  jar = torch.einsum('bev,bv->be', J, x) - aref
  parts = []
  for k, (rows, mu, scale) in sorted(lay.ell_groups.items()):
    if condim is not None and k != condim:
      continue
    rows_t = torch.as_tensor(rows, device=J.device)
    y = jar[:, rows_t] * torch.as_tensor(scale, dtype=J.dtype,
                                         device=J.device)
    mu_t = torch.as_tensor(mu, dtype=J.dtype, device=J.device)
    n, t = y[..., 0], y[..., 1:].norm(dim=-1).clamp(min=1e-15)
    on = active[:, rows_t[:, 0]] > 0
    top, bottom = n >= mu_t * t, mu_t * n <= -t
    parts.append((on, top, bottom))
  on, top, bottom = (torch.cat(x, dim=1) for x in zip(*parts))
  mid = ~top & ~bottom
  count = int(on.sum())
  return on, {z: int((mask & on).sum()) / max(count, 1)
              for z, mask in (('top', top), ('bottom', bottom),
                              ('mid', mid))}


# -- phase train: gradients through the step, and SAC on the card ------------
# the phase's generator seed; K1's autograd Functions at cheetah's n = 9,
# humanoid's 27 and humanoid_CMU's 62; lqr's rollout lanes and control
# steps: lqr_2_1 the 2500 of the JAX package's tests/test_extras.py:18-35,
# lqr_6_2 6000, as its slowest closed-loop mode (|eigenvalue| 0.99913 of
# A - BK) leaves up to 0.12 of a start on the sqrt(2) sphere after 2500
# steps and 4.3e-3 after 6000 (the float64 linear map's norm on the
# positions); the SAC train steps
TRAIN_SEED = 80
TRAIN_K1 = (9, 27, 62)
LQR_LANES = 256
LQR_STEPS = {'lqr_2_1': 2500, 'lqr_6_2': 6000}
TRAIN_STEPS = 20
# lqr on the card: A and B from the kernels (float32) within LQR_AB_TOL of
# the float64 plain path's, K within LQR_K_TOL, each relative to the
# matrix's largest entry (on the CPU, float32 against float64: 1.2e-7,
# 3.7e-7 and 6.4e-6 at lqr_6_2); at the end of the rollout every lane's
# |(qpos, qvel)| under LQR_X_TOL and its reward over LQR_REWARD (the JAX
# package's test)
LQR_AB_TOL, LQR_K_TOL = 1e-5, 1e-4
LQR_X_TOL, LQR_REWARD = 1e-2, 0.999
# one SAC update on the card against the same update at float64 on the
# CPU: each gradient tensor within SAC_GRAD_TOL of its largest entry; each
# updated parameter within SAC_PARAM_TOL x lr (Adam's step is lr m / (sqrt(v)
# + eps), |m| <= ~sqrt(v): a float32 gradient near zero that flips its sign
# moves a parameter up to ~2 lr from the float64 one)
SAC_GRAD_TOL, SAC_PARAM_TOL = 1e-3, 2.0


def data_tensors(d):
  """Every tensor of a batched Data (its Contact's and model_var's too),
  in a fixed order."""
  import dataclasses
  for f in dataclasses.fields(d):
    x = getattr(d, f.name)
    if f.name == 'contact':
      yield from data_tensors(x)
    elif f.name == 'model_var':
      yield from (v for _, v in sorted((x or {}).items()))
    else:
      yield x


def k1_autograd(dev, gen):
  """K1's autograd Functions (`_src/linalg.py`) on the card at (BATCH, n)
  for n in TRAIN_K1: forward and backward (random cotangents) with the
  kernels' forward, held by `ell_gates` against the same Functions with
  the plain forward at float32 and at float64 (outputs and every input's
  cotangent, each flattened per lane); ms per forward, per forward +
  backward, the plain forward + backward's, and the one torch.linalg
  call's forward + backward (`library_forward_backward_ms`).  The
  backward is torch ops on the saved factor or solution (the JAX package's
  tangent path is plain jax.scipy code), so its time is the Function's,
  not a kernel's.  Returns {kernel: {'n=<n>': stats}}."""
  import contextlib
  import torch
  from dm_control_tpu_torch._src import linalg
  from dm_control_tpu_torch.ops import linalg_kernel as lk
  out = {k: {} for k in K1_PLAIN}
  for n in TRAIN_K1:
    a = torch.randn((BATCH, n, n), generator=gen, device=dev)
    A = a @ a.transpose(1, 2) + n * torch.eye(n, device=dev)
    b = torch.randn((BATCH, n), generator=gen, device=dev)
    L = lk.cholesky_plain(A)
    l_bar = torch.randn((BATCH, n, n), generator=gen, device=dev)
    x_bar = torch.randn((BATCH, n), generator=gen, device=dev)
    mat, vec = BATCH * n * n * 4, BATCH * n * 4
    # (Function, inputs, cotangent, library call, bytes: inputs and
    # cotangent read once, output and input cotangents written once;
    # FLOPs of forward and backward as written)
    cases = {
        'cholesky_batched': (
            linalg.cholesky, (A,), l_bar, torch.linalg.cholesky, 4 * mat,
            BATCH * (n ** 3 / 3 + 4 * n ** 3)),
        'cho_solve_batched': (
            linalg.cho_solve, (L, b), x_bar,
            lambda l_, b_: torch.cholesky_solve(b_[..., None], l_)[..., 0],
            2 * mat + 4 * vec, BATCH * (2 * n ** 3 + 6 * n * n)),
        'chol_solve_batched': (
            linalg.solve_psd, (A, b), x_bar, torch.linalg.solve,
            2 * mat + 4 * vec, BATCH * (2 * n ** 3 / 3 + 7 * n * n))}
    for k, (fn, args, cot, library, nbytes, flops) in cases.items():

      def fwd_bwd(dtype, plain, fn=fn, args=args, cot=cot):
        ins = [x.to(dtype).detach().requires_grad_() for x in args]
        with linalg.plain() if plain else contextlib.nullcontext():
          y = fn(*ins)
          grads = torch.autograd.grad(y, ins, cot.to(dtype))
        return [y.detach()] + list(grads)

      got = fwd_bwd(torch.float32, False)
      plain32 = fwd_bwd(torch.float32, True)
      ref = fwd_bwd(torch.float64, True)
      names = ['output'] + [f'cotangent {i}' for i in range(len(args))]
      errs = {}
      for what, x_k, x_p, x_64 in zip(names, got, plain32, ref):
        flat = [x.reshape(BATCH, -1) for x in (x_k, x_p, x_64)]
        vs_p, vs_64 = ell_gates(f'{k} autograd n={n} {what}', *flat,
                                quiet=True)
        errs[what] = (flat[0] - flat[1]).abs().max().item()
        log(f'#   {k} autograd n={n} {what}: lane-scaled (mean, max, lanes '
            f'over 1e-3) kernel vs plain float32 {vs_p}, vs float64 {vs_64}')
      b_ms, b_by = bound_ms(nbytes, flops)
      out[k][f'n={n}'] = dict(
          shape=[BATCH, n, n], max_abs_err_vs_plain=errs,
          forward_ms=cuda_ms(lambda fn=fn, args=args: fn(*args), 20),
          forward_backward_ms=cuda_ms(
              lambda: fwd_bwd(torch.float32, False), 20),
          plain_forward_backward_ms=cuda_ms(
              lambda: fwd_bwd(torch.float32, True), 3),
          library_forward_backward_ms=cuda_ms(
              lambda fn=library: fwd_bwd(torch.float32, False, fn=fn), 20),
          bound_ms=b_ms, bound_by=b_by)
      log(f'# phase train: {k} autograd n={n}: {out[k][f"n={n}"]}')
  return out


def lqr_rollout(task, k, seed, steps, lk, dev):
  """LQR_LANES lanes of `task` from its episode init (the sqrt(2) sphere)
  under u = -K x for `steps` control steps of `forward.step` on the card
  at float32, replayed from one CUDA graph of a control step: the policy,
  the step, and the step's Data copied back into the graph's input.
  Returns (final Data, seconds of the replays, launches of each K1 kernel
  recorded in the graph: the launches of every replay)."""
  import dataclasses
  import torch
  from dm_control_tpu_torch._src import forward
  from dm_control_tpu_torch.parallel import BatchedEnv
  m = task.model
  d = BatchedEnv(task, LQR_LANES).reset(seed=seed).data
  assert torch.allclose(d.qpos.norm(dim=1), torch.full(
      (LQR_LANES,), math.sqrt(2.0), device=dev)), 'lqr: start off the sphere'
  gain = torch.tensor(k, dtype=torch.float32, device=dev)

  def clone(x):
    if dataclasses.is_dataclass(x):
      return x.replace(**{f.name: clone(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, dict):
      return {key: v.clone() for key, v in x.items()}
    return x.clone()

  def control(d):
    x = torch.cat([d.qpos, d.qvel], dim=1)
    return forward.step(m, d.replace(ctrl=-(x @ gain.T)))

  static = clone(d)             # the graph's input, no field aliasing another
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(2):          # cuBLAS handles, the Model's mirrored arrays
      control(static)
  torch.cuda.current_stream().wait_stream(side)
  torch.cuda.synchronize()
  lk.reset_launches()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    new = control(static)
    for x, y in zip(data_tensors(static), data_tensors(new)):
      if x.data_ptr() != y.data_ptr():
        x.copy_(y)
  recorded = dict(lk.LAUNCHES)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(steps):
    graph.replay()
  torch.cuda.synchronize()
  return static, time.perf_counter() - t0, recorded


def lqr_phase(lk, dev):
  """lqr_2_1 and lqr_6_2 on the card: `lqr_solver.linearize` through the
  kernels (float32; K1a and K1c launched exactly once per forward and
  per step, none in the backward) and through the plain versions
  (float64, `plain=True`; no launch); A, B and K held against float64;
  then LQR_LANES lanes regulated by the kernels' K (`lqr_rollout`).
  Returns {task: stats}."""
  import numpy as np
  import torch
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch.utils import lqr_solver
  out = {}
  for i, name in enumerate(LQR_STEPS):
    task = suite.build_task('lqr', name, device=dev)
    n_sub, nq = task.n_sub_steps(), task.model.nq
    runs = {}
    for dtype, plain in ((torch.float32, False), (torch.float64, True)):
      torch.cuda.synchronize()
      lk.reset_launches()
      t0 = time.perf_counter()
      ab = lqr_solver.linearize(task, dtype=dtype, plain=plain)
      runs[plain] = (ab, time.perf_counter() - t0, dict(lk.LAUNCHES))
    (a32, b32), t32, launches = runs[False]
    (a64, b64), t64, plain_launches = runs[True]
    want = {'cholesky_batched': 1 + n_sub, 'chol_solve_batched': 0,
            'cho_solve_batched': 1 + n_sub}
    assert launches == want, f'lqr {name} linearize: {launches} != {want}'
    assert not any(plain_launches.values()), plain_launches
    k32 = lqr_solver.riccati_gain(a32, b32, nq)
    k64 = lqr_solver.riccati_gain(a64, b64, nq)
    rel = {what: np.abs(x - ref).max() / np.abs(ref).max()
           for what, x, ref in (('A', a32, a64), ('B', b32, b64),
                                ('K', k32, k64))}
    radius = float(np.abs(np.linalg.eigvals(a64 - b64 @ k32)).max())
    log(f'# phase train: lqr {name} linearize: kernels float32 {t32:.3f} s '
        f'(launches {launches}), plain float64 {t64:.3f} s; error relative '
        f'to the largest entry A {rel["A"]:.2e} B {rel["B"]:.2e} K '
        f'{rel["K"]:.2e}; spectral radius of A - B K {radius:.6f} (float64 '
        f'A, B; the kernels\' K)')
    assert rel['A'] <= LQR_AB_TOL and rel['B'] <= LQR_AB_TOL, rel
    assert rel['K'] <= LQR_K_TOL and radius < 1.0, (rel, radius)
    steps = LQR_STEPS[name]
    d, dt, per_step = lqr_rollout(task, k32, TRAIN_SEED + i, steps, lk, dev)
    want = {'cholesky_batched': 1, 'chol_solve_batched': 0,
            'cho_solve_batched': 1}
    assert per_step == want, f'lqr {name} rollout graph: {per_step}'
    norm = torch.sqrt((d.qpos * d.qpos).sum(1) + (d.qvel * d.qvel).sum(1))
    reward = task.get_reward(task.model, d)
    log(f'# phase train: lqr {name} rollout: {LQR_LANES} lanes x {steps} '
        f'control steps in {dt:.2f} s ({1e3 * dt / steps:.4f} ms per step, '
        f'one CUDA graph replay each, K1 launches per replay {per_step}); '
        f'|x| at the end max {norm.max().item():.3e} median '
        f'{norm.median().item():.3e}; reward min {reward.min().item():.6f}')
    assert bool(torch.isfinite(norm).all()), f'lqr {name}: not finite'
    assert bool((norm < LQR_X_TOL).all()), (
        f'lqr {name}: |x| {norm.max().item():.3e} >= {LQR_X_TOL}')
    assert bool((reward > LQR_REWARD).all()), (
        f'lqr {name}: reward {reward.min().item():.6f} <= {LQR_REWARD}')
    out[name] = dict(
        linearize_s=t32, linearize_float64_plain_s=t64,
        linearize_launches=launches, rel_err=rel, spectral_radius=radius,
        rollout_steps=steps, rollout_s=dt, rollout_launches={
            key: v * steps for key, v in per_step.items()},
        max_final_norm=norm.max().item(),
        min_final_reward=reward.min().item())
  return out


def sac_phase(lk, nk, dev):
  """`make_sac_trainer('cheetah', 'run', BATCH)` with the default
  SACConfig: TRAIN_STEPS train steps, each kernel's launches exactly
  TRAIN_STEPS x `expected_launches` (no lane resets: cheetah has no
  termination and no time limit here), metrics finite, the actor moved;
  env-steps/s and updates/s (medians of the steps after the first) and
  the share of a step in `update`; then one update on the card against the
  same update at float64 on the CPU (the state through the bridge, the
  same batch and normal draws).  Returns (stats, launches)."""
  import torch
  from dm_control_tpu_torch import bridge
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch.parallel import distributed
  from dm_control_tpu_torch.rl import sac as sac_lib
  t0 = time.perf_counter()
  carry, train = distributed.make_sac_trainer('cheetah', 'run', BATCH,
                                              seed=TRAIN_SEED, device=dev)
  learner, env = train.sac, train.env
  torch.cuda.synchronize()
  t_build = time.perf_counter() - t0
  actor0 = [p.detach().clone() for p in carry[0].actor.parameters()]
  update, update_s = learner.update, []

  def timed_update(*args, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    result = update(*args, **kw)
    torch.cuda.synchronize()
    update_s.append(time.perf_counter() - t)
    return result

  learner.update = timed_update
  step_s, history = [], []
  torch.cuda.synchronize()
  lk.reset_launches()
  nk.reset_launches()
  for _ in range(TRAIN_STEPS):
    t = time.perf_counter()
    carry, metrics = train(carry)
    torch.cuda.synchronize()
    step_s.append(time.perf_counter() - t)
    history.append(metrics)
  launches = dict(lk.LAUNCHES, **nk.LAUNCHES)
  del learner.update
  state, run_state, replay, _ = carry
  want = {k: v * TRAIN_STEPS for k, v in expected_launches(env.task).items()}
  assert launches == want, f'SAC train steps: {launches} != {want}'
  assert not bool(run_state.episode_id.any()), 'SAC: an episode ended'
  assert int(state.step) == TRAIN_STEPS and replay.size == (
      TRAIN_STEPS * BATCH)
  for metrics in history:
    for k, v in metrics.items():
      assert math.isfinite(float(v)), f'SAC metric {k} not finite'
  moved = sum((p.detach() - p0).abs().sum().item()
              for p, p0 in zip(state.actor.parameters(), actor0))
  assert moved > 0, 'SAC: the actor did not change'
  later = sorted(step_s[1:])
  mid = later[len(later) // 2]
  share = sorted(u / s for u, s in zip(update_s[1:], step_s[1:]))
  stats = dict(
      build_s=t_build, train_steps=TRAIN_STEPS, first_step_s=step_s[0],
      step_ms_median=1e3 * mid, env_steps_per_s=BATCH / mid,
      updates_per_s=1.0 / mid,
      update_ms_median=1e3 * sorted(update_s[1:])[len(later) // 2],
      update_share_median=share[len(share) // 2],
      last_metrics={k: float(v) for k, v in history[-1].items()})
  log(f'# phase train: SAC cheetah-run@{BATCH} (hidden '
      f'{learner.config.hidden}, learn batch {learner.config.learn_batch}, '
      f'replay {learner.config.replay_capacity}): trainer built in '
      f'{t_build:.2f} s; {TRAIN_STEPS} train steps, launches {launches} '
      f'(= {TRAIN_STEPS} x expected); {stats}')

  # one update on the card against the same update at float64 on the CPU
  gen = torch.Generator(device=dev)
  gen.manual_seed(TRAIN_SEED + 1)
  cfg = learner.config
  batch = sac_lib.replay_sample(replay, gen, cfg.learn_batch)
  noise = [torch.randn((cfg.learn_batch, learner.act_dim), generator=gen,
                       device=dev) for _ in range(2)]
  cpu = sac_lib.SAC(suite.build_task('cheetah', 'run', device='cpu'), cfg,
                    dtype=torch.float64)
  cpu_state = bridge.sac_state_from_numpy(bridge.sac_state_to_numpy(state),
                                          'cpu', torch.float64)
  to64 = lambda xs: [x.detach().cpu().double() for x in xs]
  batch64, noise64 = to64(batch), to64(noise)
  g32, _ = learner.gradients(state, batch, noise=noise)
  g64, _ = cpu.gradients(cpu_state, batch64, noise=noise64)
  grad_rel = max((a.detach().cpu().double() - b).abs().max().item()
                 / max(b.abs().max().item(), 1e-30)
                 for a, b in zip(g32, g64))
  _, m32 = learner.update(state, batch, noise=noise)
  _, m64 = cpu.update(cpu_state, batch64, noise=noise64)
  after32 = bridge.sac_state_to_numpy(state)
  after64 = bridge.sac_state_to_numpy(cpu_state)
  param_err = 0.0
  for key in ('actor', 'q1', 'q2', 'q1_target', 'q2_target'):
    for l32, l64 in zip(after32[key], after64[key]):
      for f in ('w', 'b'):
        param_err = max(param_err, float(abs(l32[f] - l64[f]).max()))
  param_err = max(param_err, float(abs(after32['log_alpha']
                                       - after64['log_alpha'])))
  metric_err = {k: abs(float(m32[k]) - float(m64[k])) for k in m64}
  log(f'# phase train: SAC update, card float32 vs CPU float64 (same state, '
      f'batch, draws): gradients max error relative to each tensor\'s '
      f'largest entry {grad_rel:.2e} (bound {SAC_GRAD_TOL}); updated '
      f'parameters max abs error {param_err:.2e} (bound {SAC_PARAM_TOL} x '
      f'lr = {SAC_PARAM_TOL * cfg.lr:.1e}); metrics {metric_err}')
  assert grad_rel <= SAC_GRAD_TOL, grad_rel
  assert param_err <= SAC_PARAM_TOL * cfg.lr, param_err
  stats.update(grad_rel_err=grad_rel, param_abs_err=param_err)
  return stats, launches


def train_phase(lk, nk, rows, dev):
  """Phase train (see the module docstring); adds this phase's entries to
  the kernel rows `rows`."""
  import torch
  t_phase = time.perf_counter()
  gen = torch.Generator(device=dev)
  gen.manual_seed(TRAIN_SEED)
  autograd = k1_autograd(dev, gen)
  t_k1 = time.perf_counter() - t_phase
  t0 = time.perf_counter()
  lqr = lqr_phase(lk, dev)
  t_lqr = time.perf_counter() - t0
  torch.cuda.synchronize()
  lk.reset_launches()
  nk.reset_launches()
  t0 = time.perf_counter()
  sac, launches = sac_phase(lk, nk, dev)
  t_sac = time.perf_counter() - t0
  for r in rows:
    k = r['name']
    if k in launches and launches[k]:
      r['train'] = dict(task='cheetah-run', batch=BATCH, steps=TRAIN_STEPS,
                        launches=launches[k],
                        launches_per_train_step=launches[k] / TRAIN_STEPS)
    if k in autograd:
      r['autograd'] = autograd[k]
      r['lqr'] = {name: dict(linearize_launches=s['linearize_launches'][k],
                             rollout_launches=s['rollout_launches'][k])
                  for name, s in lqr.items()}
  log(f'# phase train: {time.perf_counter() - t_phase:.1f} s (K1 autograd '
      f'{t_k1:.1f}, lqr {t_lqr:.1f}, SAC {t_sac:.1f}); lqr {lqr}; SAC {sac}')
  return sac


# -- 8. composer: the locomotion tier through BatchedEnvironment -------------
# The fourteenth slice's tasks through the composer's BatchedEnvironment (one
# `forward.step` per physics substep, the observation pipeline after each):
# the Ant walker on go_to_target, run_through_corridor, random_goal_maze and
# escape (nv 14; maze's 32 box walls, escape's per-lane heightfield), the CMU
# humanoid on go_to_target (nv 62: K2's two dofs per lane at a new layout),
# the rodent on two_touch (nv 73: the core with K1b) and the jumping ball on
# go_to_target (nv 8); the phase's generator seed, each task's control
# steps (5 where not named), and the tasks held without the reference gate
# (ROADMAP queue 3, item 7; `tools/composer_reference_lanes.py` runs their
# gates and writes their lanes, `tools/reference_step_cpu.py --tasks
# composer:T --states FILE` replays them on the CPU): two_touch, whose
# rodent's float32 Newton solve (the core, as dog's) fails 188 lanes with K1
# as kernels and 201 with K1 plain, where the JAX package's float32 step
# fails 25 of the first 32 as the card does; and go_to_target with the CMU
# humanoid, which fails only the excused-count rule (4 lanes with every
# choice matched and solves within the band, against 0 with K1 plain; the
# JAX package's float32 step excuses 4 other lanes of the same states)
COMPOSER_SEED = 90
COMPOSER_TASKS = ('go_to_target-ant', 'go_to_target-cmu',
                  'run_through_corridor', 'random_goal_maze', 'escape',
                  'two_touch', 'go_to_target-jumping_ball')
COMPOSER_STEPS = {'go_to_target-cmu': 3, 'two_touch': 2}
COMPOSER_UNGATED = ('go_to_target-cmu', 'two_touch')
# the tasks whose states hold K2 (or, past 64 dofs, the core) at their
# layouts, and the tasks whose initial mass matrices hold K1 at n = 14, 8
# and 73
COMPOSER_K2 = ('go_to_target-ant', 'go_to_target-cmu', 'run_through_corridor',
               'random_goal_maze', 'two_touch', 'go_to_target-jumping_ball')
COMPOSER_K1 = ('go_to_target-ant', 'go_to_target-jumping_ball', 'two_touch')
# the episode limits (control steps, and the task's control timestep) of
# the runs in which every lane resets
COMPOSER_LIMITS = {'go_to_target-ant': (2, 0.025), 'two_touch': (1, 0.03)}
# each task's rewards, read from its reward function (locomotion/tasks.py):
# go_to_target's and random_goal_maze's indicators take 0 or 1; two_touch's
# pulses 0, touch_reward 0.2 or timing_reward 1.0 (aliveness_reward 0); the
# corridor's and escape's linear tolerances lie in [0, 1]
COMPOSER_REWARD_VALUES = {'go_to_target-ant': (0.0, 1.0),
                          'go_to_target-cmu': (0.0, 1.0),
                          'go_to_target-jumping_ball': (0.0, 1.0),
                          'random_goal_maze': (0.0, 1.0),
                          'two_touch': (0.0, 0.2, 1.0)}


def composer_env(what, batch, time_limit=None, device=None):
  """The port's BatchedEnvironment of composer task `what` (COMPOSER_TASKS)
  at `batch` lanes on `device` (the card unless named)."""
  from dm_control_tpu_torch.locomotion import tasks
  from dm_control_tpu_torch.locomotion import walkers
  kw = dict(batch_size=batch, device=device)
  if time_limit is not None:
    kw['time_limit'] = time_limit
  if what.startswith('go_to_target-'):
    walker = {'ant': walkers.Ant, 'cmu': walkers.CMUHumanoid,
              'jumping_ball': walkers.JumpingBallWithHead}[what.split('-')[1]]
    return tasks.go_to_target(walker=walker(), **kw)
  return getattr(tasks, what)(**kw)


def composer_launches(env):
  """Each kernel's launches per control step of composer environment
  `env`: n physics substeps, each one `forward.step`: the acc stage (K1c,
  then K2, or K2-ell where the model's contacts are elliptic, if it has
  constraint rows), Euler's implicit damping (K1b, where a dof is damped)
  and step1 (K1a); under RK4 three more pipelines per step (K1a, K1c and a
  solve each) and no K1b.  Past the Newton kernel's dofs (the rodent) the
  solve is the core, whose K1b launches (its loop iterations,
  `newton_kernel.CORE_LOOPS`) come on top; `composer_core_calls` counts its
  calls.  Unlike `substeps` (`expected_launches`) there is no extra step1
  sync per control step."""
  import numpy as np
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src.types import Integrator
  from dm_control_tpu_torch.ops import newton_kernel as nk
  m, n = env.model, env.n_sub_steps
  lay = efc.layout(m)
  rk4 = m.opt.integrator == Integrator.RK4
  stages = (4 if rk4 else 1) * n
  solves = stages if lay.nefc and m.nv <= nk.MAX_NV else 0
  ell = bool(lay.ell_groups)
  return {'cholesky_batched': stages, 'cho_solve_batched': stages,
          'chol_solve_batched': 0 if rk4 or not np.any(m.dof_damping > 0)
                                else n,
          'newton_solve_batched': 0 if ell else solves,
          'newton_solve_ell': solves if ell else 0}


def composer_core_calls(env):
  """The core's calls per control step of composer environment `env`: one
  per acc stage where the model is past the Newton kernel's dofs."""
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src.types import Integrator
  from dm_control_tpu_torch.ops import newton_kernel as nk
  m = env.model
  stages = (4 if m.opt.integrator == Integrator.RK4 else 1) * env.n_sub_steps
  return stages if efc.layout(m).nefc and m.nv > nk.MAX_NV else 0


def composer_controls(i_task, nu, lanes, dev):
  """Composer task number `i_task`'s controls (its rollout's, its gate's),
  uniform in [-1, 1] (every locomotion actuator's range), from a generator
  of its own."""
  import torch
  gen = torch.Generator(device=dev)
  gen.manual_seed(COMPOSER_SEED + 1 + i_task)
  return lambda n=lanes: torch.rand((n, nu), generator=gen,
                                    device=dev) * 2 - 1


def lanes_in_contact(m, d):
  """Lanes of d with an active row past the equalities, friction losses
  and joint limits (a contact)."""
  from dm_control_tpu_torch._src import efc
  lay = efc.layout(m)
  first = (int((lay.types == efc.EQUALITY).sum()) + len(lay.fric_dof)
           + len(lay.lim_jnt))
  return int(d.efc_active[:, first:].any(dim=1).sum())


def composer_k1(lk, what, A, b, launches, reps=50):
  """K1a/b/c on composer task `what`'s initial (B, n, n) mass matrices and
  (B, n) smooth forces: each mode held by `ell_gates` against its plain
  float32 and float64 versions, the bit checks (`k1_bits`), then its
  kernels line entry (wrapper, plain and torch.linalg times, bound)."""
  B, n, _ = A.shape
  L_ref = lk.cholesky_plain(A)
  A64, b64, L64 = A.double(), b.double(), L_ref.double()
  triples = {
      'cholesky_batched': (lk.cholesky_batched(A), L_ref,
                           lk.cholesky_plain(A64)),
      'chol_solve_batched': (lk.chol_solve_batched(A, b),
                             lk.chol_solve_plain(A, b),
                             lk.chol_solve_plain(A64, b64)),
      'cho_solve_batched': (lk.cho_solve_batched(L_ref, b),
                            lk.cho_solve_plain(L_ref, b),
                            lk.cho_solve_plain(L64, b64))}
  for k, (x, ref, x_64) in triples.items():
    ell_gates(f'{k} n={n} on {what}\'s initial states', x.flatten(1),
              ref.flatten(1), x_64.flatten(1))
  k1_bits(lk, A, b, triples['cholesky_batched'][0],
          triples['chol_solve_batched'][0],
          lk.cho_solve_batched(triples['cholesky_batched'][0], b))
  import torch
  mat, vec = B * n * n * 4, B * n * 4
  calls = {
      'cholesky_batched': (lambda: lk.cholesky_batched(A),
                           lambda: lk.cholesky_plain(A),
                           lambda: torch.linalg.cholesky(A), 2 * mat,
                           B * n ** 3 / 3),
      'chol_solve_batched': (lambda: lk.chol_solve_batched(A, b),
                             lambda: lk.chol_solve_plain(A, b),
                             lambda: torch.linalg.solve(A, b), mat + 2 * vec,
                             B * (n ** 3 / 3 + 2 * n * n)),
      'cho_solve_batched': (lambda: lk.cho_solve_batched(L_ref, b),
                            lambda: lk.cho_solve_plain(L_ref, b),
                            lambda: torch.cholesky_solve(b[..., None], L_ref),
                            mat + 2 * vec, B * 2 * n * n)}
  out = {}
  for k, (fn, plain, library, nbytes, flops) in calls.items():
    b_ms, b_by = bound_ms(nbytes, flops)
    x, ref = triples[k][:2]
    out[k] = dict(launches=launches[k],
                  max_abs_err=(x - ref).abs().max().item(),
                  ms=cuda_ms(fn, reps), plain_ms=cuda_ms(plain, 5),
                  bound_ms=b_ms, bound_by=b_by,
                  library_ms=cuda_ms(library, reps), shape=[B, n, n])
  log(f'# phase composer: K1 n={n} on {what}: {out}')
  return out


def composer_phase(lk, nk, rows, dev):
  """Phase composer (see the module docstring); adds this phase's entries
  to the kernel rows `rows`."""
  import numpy as np
  import torch
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src import forward
  from dm_control_tpu_torch._src import solver
  t_phase = time.perf_counter()
  k1_sub, k2_sub, core_sub, sps = {}, {}, {}, {}
  for i_task, what in enumerate(COMPOSER_TASKS):
    # the last task's environment and states go before this one's come
    env = carry = best = obs = None
    torch.cuda.empty_cache()
    t_task = time.perf_counter()
    env = composer_env(what, BATCH)
    m = env.model
    lay = efc.layout(m)
    per_step, calls = composer_launches(env), composer_core_calls(env)
    per_reset = reset_launches(env)
    steps = COMPOSER_STEPS.get(what, 5)
    controls = composer_controls(i_task, m.nu, BATCH, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = env.reset(seed=i_task)
    torch.cuda.synchronize()
    t_reset = time.perf_counter() - t0
    if what in COMPOSER_K1:
      init_k1 = (carry.data.qM.contiguous(), carry.data.qfrc_smooth.contiguous())
    lk.reset_launches()
    nk.reset_launches()
    resets0 = env.reset_calls
    rewards, best, in_contact = [], None, []
    t0 = time.perf_counter()
    for _ in range(steps):
      carry, (obs, reward, done) = env.step(carry, controls())
      rewards.append(reward)
      if what in COMPOSER_K2:
        # the solver inputs of K2's check: the step's states with the most
        # lanes in contact (the Ant's kick off its knee limits leaves it
        # airborne after its first control step)
        in_contact.append(lanes_in_contact(m, carry.data))
        if in_contact[-1] == max(in_contact):
          best = carry.data
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = dict(lk.LAUNCHES, **nk.LAUNCHES)
    core = dict(nk.CORE_LOOPS)
    resets = env.reset_calls - resets0
    rewards = torch.stack(rewards)
    sps[what] = BATCH * steps / dt
    log(f'# phase composer: {what}@{BATCH} (nv {m.nv}, nefc {lay.nefc}, '
        f'{env.n_sub_steps} substeps, {len(obs)} observables): reset '
        f'{t_reset:.2f} s; {steps} control steps in {dt:.2f} s '
        f'({sps[what]:.1f} env-steps/s); launches {got}; core {core}; '
        f'auto-resets {resets}; rewards {sorted(set(rewards.flatten().tolist()))[:8]} '
        f'(mean {rewards.mean().item():.4f}); lanes in contact after each '
        f'step {in_contact}; peak memory allocated '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    for f, x in forward.state_items(forward.state_of(carry.data)):
      assert x.dtype == torch.bool or torch.isfinite(x).all(), (
          f'{what}: {f} not finite')
    shapes = env.pipeline.shapes
    assert obs.keys() == shapes.keys(), (what, obs.keys())
    for k, x in obs.items():
      assert tuple(x.shape) == (BATCH,) + shapes[k], (what, k, x.shape)
      assert bool(torch.isfinite(x).all()), f'{what}: observation {k}'
    assert tuple(rewards.shape) == (steps, BATCH)
    allowed = COMPOSER_REWARD_VALUES.get(what)
    if allowed is None:
      assert bool(((rewards >= 0) & (rewards <= 1)).all()), (
          f'{what}: reward outside [0, 1]')
    else:
      ok = torch.zeros_like(rewards, dtype=torch.bool)
      for v in allowed:
        ok |= rewards == torch.tensor(v, dtype=rewards.dtype)
      assert bool(ok.all()), f'{what}: a reward outside {allowed}'
    assert resets == 0, f'{what}: {resets} auto-resets in the rollout'
    assert core['calls'] == calls * steps, (what, core)
    want = {k: v * steps for k, v in per_step.items()}
    want['chol_solve_batched'] += core['loops']
    assert got == want, f'{what}: launches {got}, expected {want}'
    log(f'# {what}@{BATCH}: launches per control step {per_step}'
        + (f' and the core\'s K1b launches ({core})' if calls else ''))

    # the kernels at the task's layouts, held against their plain versions
    if what in COMPOSER_K1:
      k1_sub[what] = composer_k1(lk, what, *init_k1, got)
      init_k1 = None
    if what in COMPOSER_K2 and m.nv <= nk.MAX_NV:
      args, kw, iters, err, _, _ = k2_task_check(nk, what, m, lay, best)
      b_ms, b_by = bound_ms(k2_bytes(BATCH, lay.nefc, m.nv),
                            newton_flops(lay.nefc, m.nv, solver.LS_ITERATIONS,
                                         iters))
      k2_sub[what] = dict(
          launches=got['newton_solve_batched'], max_abs_err=err,
          ms=cuda_ms(lambda: nk.newton_solve_batched(*args, lay=lay, **kw),
                     10),
          plain_ms=cuda_ms(lambda: nk.newton_solve_plain(
              *args, types=lay.types, **kw), 2),
          bound_ms=b_ms, bound_by=b_by, library_ms=None,
          max_iters=int(iters.max()), shape=[BATCH, lay.nefc, m.nv],
          launch_config=list(nk.launch_config(lay.nefc, m.nv, 0)),
          launches_per_control_step=got['newton_solve_batched'] / steps)
      log(f'# phase composer: K2 on {what}: {k2_sub[what]}')
    elif what in COMPOSER_K2:
      args, kw, iters, err, _, loops = core_task_check(nk, lk, what, m, lay,
                                                       best)
      b_ms, b_by = bound_ms(k2_bytes(BATCH, lay.nefc, m.nv),
                            newton_flops(lay.nefc, m.nv, solver.LS_ITERATIONS,
                                         iters))
      core_sub[what] = dict(
          launches=got['chol_solve_batched'], k1b_launches_per_call=loops,
          core_calls=core['calls'], core_loops=core['loops'],
          max_abs_err=err,
          ms=cuda_ms(lambda: nk.newton_solve_core(*args, lay=lay, **kw), 3),
          plain_ms=cuda_ms(lambda: nk.newton_solve_plain(
              *args, types=lay.types, **kw), 1),
          bound_ms=b_ms, bound_by=b_by, library_ms=None,
          max_iters=int(iters.max()), shape=[BATCH, lay.nefc, m.nv],
          launches_per_control_step=got['chol_solve_batched'] / steps)
      log(f'# phase composer: core (K1b inside) on {what}: {core_sub[what]}')
    args = best = None
    # the reference gate on the run's final states
    if what in COMPOSER_UNGATED:
      log(f'# phase composer: {what}: no gate (COMPOSER_UNGATED)')
    else:
      t0 = time.perf_counter()
      reference_gate(what, m, carry.data, controls(REF_LANES),
                     env.n_sub_steps, lk)
      log(f'# phase reference: {what} {time.perf_counter() - t0:.1f} s')
    log(f'# phase composer: {what}: {time.perf_counter() - t_task:.1f} s')

  # Episode limits that end every lane's episode at the last control step:
  # each lane's state, model_var and buffers are then its fresh draw (the
  # same generator state drawn again), its substep counter 1, and the step
  # launches a forward's kernels more
  env = carry = obs = None
  torch.cuda.empty_cache()
  for what, (limit, control_dt) in COMPOSER_LIMITS.items():
    i_task = COMPOSER_TASKS.index(what)
    env = composer_env(what, BATCH, time_limit=limit * control_dt)
    assert env.step_limit == limit, (what, env.step_limit)
    controls = composer_controls(i_task, env.model.nu, BATCH, dev)
    carry = env.reset(seed=len(COMPOSER_TASKS) + i_task)
    old = dict(carry.data.model_var)
    for _ in range(limit - 1):
      carry, _ = env.step(carry, controls())
    drawn = env.generator.get_state()
    torch.cuda.synchronize()
    lk.reset_launches()
    nk.reset_launches()
    carry, (obs, reward, done) = env.step(carry, controls())
    torch.cuda.synchronize()
    got = dict(lk.LAUNCHES, **nk.LAUNCHES)
    core = dict(nk.CORE_LOOPS)
    assert bool(done.all()) and env.reset_calls == 1, (what, env.reset_calls)
    env.generator.set_state(drawn)
    fresh, fresh_obs = env._loop.fresh(BATCH, env.generator)
    assert set(carry.data.model_var) == set(fresh.model_var) == set(old)
    for k, v in carry.data.model_var.items():
      assert torch.equal(v, fresh.model_var[k]), f'{what}: {k} not its draw'
    moved = carry.data.model_var['geom_pos'] != old['geom_pos']
    assert bool(moved.flatten(1).any(dim=1).all()), (
        f'{what}: a lane kept its old geom_pos')
    for f in ('qpos', 'qvel', 'act', 'time'):
      assert torch.equal(getattr(carry.data, f), getattr(fresh, f)), f
    for n, st in carry.obs_state.items():
      for k, x in st.items():
        assert torch.equal(x, fresh_obs[n][k]), f'{what}: buffer {n} {k}'
    assert bool((carry.substep == 1).all())
    want = {k: v * 1 + n for (k, v), n in zip(
        composer_launches(env).items(), reset_launches(env).values())}
    want['chol_solve_batched'] += core['loops']
    assert core['calls'] == composer_core_calls(env) + (
        1 if composer_core_calls(env) else 0), (what, core)
    assert got == want, f'{what} reset step: launches {got}, expected {want}'
    log(f'# phase composer: {what}@{BATCH}, episode limit {limit} control '
        f'steps: every lane reset; model_var {sorted(carry.data.model_var)}, '
        f'state and buffers per lane as drawn; launches {got}; core {core}')
  env = carry = obs = fresh = fresh_obs = None
  torch.cuda.empty_cache()

  for r in rows:
    if r['name'] in ('cholesky_batched', 'chol_solve_batched',
                     'cho_solve_batched'):
      for what, sub in k1_sub.items():
        r[what] = dict(sub[r['name']], launches_per_control_step=sub[
            r['name']]['launches'] / COMPOSER_STEPS.get(what, 5))
      if r['name'] == 'chol_solve_batched':
        r.setdefault('core', {}).update(core_sub)
    if r['name'] == 'newton_solve_batched':
      r.update(k2_sub)
  log(f'# phase composer: {time.perf_counter() - t_phase:.1f} s; '
      f'env-steps/s {sps}')
  return sps


# The manipulation tier (`dm_control_tpu_torch.manipulation`) through the
# composer's BatchedEnvironment: place_cradle (nv 19; the cradle's condim-6
# spheres), stack_2_bricks (nv 25; the pin hook, the goal hints,
# capsule-cylinder and box-box) and reassemble_5 (nv 43: K2's
# two-dofs-per-lane family); every model RK4 at 1 ms, 40 physics steps per
# control step.  The phase's generator seed, the tasks, and the tasks held
# without the reference gate (ROADMAP queue 3, item 9): all three, whose
# float32 steps miss float64 past the gate's rule on most lanes, as the JAX
# package's float32 step does on the same lanes (`tools/reference_step_cpu.py
# --tasks manipulation:T --states FILE`); reassemble_5's top-K box-mesh
# group is besides one `box_choices` cannot record
MANIPULATION_SEED = 100
MANIPULATION_TASKS = ('place_cradle_features', 'stack_2_bricks_features',
                      'reassemble_5_bricks_random_order_features')
MANIPULATION_UNGATED = MANIPULATION_TASKS


def manipulation_env(what, batch, device=None):
  """The port's BatchedEnvironment of manipulation task `what` at `batch`
  lanes on `device` (the card unless named)."""
  from dm_control_tpu_torch import manipulation
  return manipulation.load(what, batch_size=batch, device=device)


def manipulation_controls(i_task, m, dev):
  """Manipulation task number `i_task`'s controls: each position
  actuator's target within 0.1 rad of its joint's current angle, clamped
  to its control range (the jaco's actuators are position servos), from a
  generator of the task's own; a function of the Data and the lanes."""
  import numpy as np
  import torch
  gen = torch.Generator(device=dev)
  gen.manual_seed(MANIPULATION_SEED + 1 + i_task)
  qadr = torch.as_tensor(np.asarray(m.jnt_qposadr)[
      np.asarray(m.actuator_trnid)[:, 0]], device=dev)
  lo, hi = (torch.as_tensor(np.asarray(m.actuator_ctrlrange)[:, k],
                            dtype=torch.float32, device=dev) for k in (0, 1))

  def controls(d, n=None):
    q = d.qpos[:n, qadr] if n else d.qpos[:, qadr]
    u = torch.rand(q.shape, generator=gen, device=dev) * 0.2 - 0.1
    return torch.minimum(torch.maximum(q.float() + u, lo), hi)
  return controls


def manipulation_phase(lk, nk, rows, dev):
  """Phase manipulation (see the module docstring); adds this phase's
  entries to the kernel rows `rows`."""
  import numpy as np
  import torch
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch._src import forward
  from dm_control_tpu_torch._src import solver
  t_phase = time.perf_counter()
  k1_sub, k2_sub, sps, per_steps = {}, {}, {}, {}
  for i_task, what in enumerate(MANIPULATION_TASKS):
    env = carry = obs = stepped = fresh = fresh_obs = None
    torch.cuda.empty_cache()
    t_task = time.perf_counter()
    env = manipulation_env(what, BATCH)
    m = env.model
    lay = efc.layout(m)
    per_step, per_reset = composer_launches(env), reset_launches(env)
    per_steps[what] = per_step
    assert composer_core_calls(env) == 0 and m.nv <= nk.MAX_NV
    controls = manipulation_controls(i_task, m, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = env.reset(seed=i_task)
    torch.cuda.synchronize()
    t_reset = time.perf_counter() - t0
    init_k1 = (carry.data.qM.contiguous(), carry.data.qfrc_smooth.contiguous())
    # One control step at an episode limit of 1 ends every lane's episode,
    # so the step also resets every lane: the stepped states are kept by an
    # after_step hook of the phase's own (the step's last stage before the
    # reset), and each lane's state, model_var and buffers after the step
    # are its fresh draw (the same generator state drawn again), its
    # substep counter 1, and the step launches a forward's kernels more.
    env.step_limit = 1
    kept = []
    env._loop.hooks['after_step'].append(
        (lambda m_, d, gen, prefix: kept.append(d) or d, None))
    drawn = env.generator.get_state()
    ctrl = controls(carry.data)
    lk.reset_launches()
    nk.reset_launches()
    t0 = time.perf_counter()
    carry, (obs, reward, done) = env.step(carry, ctrl)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = dict(lk.LAUNCHES, **nk.LAUNCHES)
    (stepped,) = kept
    sps[what] = BATCH / dt
    log(f'# phase manipulation: {what}@{BATCH} (nv {m.nv}, nefc {lay.nefc}, '
        f'{env.n_sub_steps} RK4 physics steps per control step, {len(obs)} '
        f'observables): reset {t_reset:.2f} s; one control step and every '
        f'lane\'s reset in {dt:.2f} s ({sps[what]:.1f} env-steps/s); '
        f'launches {got}; rewards mean {reward.mean().item():.4f} max '
        f'{reward.max().item():.4f}; lanes in contact '
        f'{lanes_in_contact(m, stepped)}; peak memory allocated '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    for f, x in forward.state_items(forward.state_of(stepped)):
      assert x.dtype == torch.bool or torch.isfinite(x).all(), (
          f'{what}: {f} not finite')
    assert not bool(stepped.diverged.any()), f'{what}: a lane diverged'
    assert bool(((reward >= 0) & (reward <= 1)).all()), (
        f'{what}: reward outside [0, 1]')
    want = {k: v + per_reset[k] for k, v in per_step.items()}
    assert got == want, f'{what}: launches {got}, expected {want}'
    assert bool(done.all()) and env.reset_calls == 1, (what, env.reset_calls)
    env.generator.set_state(drawn)
    fresh, fresh_obs = env._loop.fresh(BATCH, env.generator)
    assert set(carry.data.model_var) == set(fresh.model_var)
    for k, v in carry.data.model_var.items():
      assert v.dtype == fresh.model_var[k].dtype, (what, k)
      assert torch.equal(v, fresh.model_var[k]), f'{what}: {k} not its draw'
      moved = (v != stepped.model_var[k]).flatten(1).any(dim=1)
      log(f'#   {what}: model_var {k} {tuple(v.shape[1:])} {v.dtype}: '
          f'lanes whose value the reset changed {int(moved.sum())}')
    for f in ('qpos', 'qvel', 'act', 'time'):
      assert torch.equal(getattr(carry.data, f), getattr(fresh, f)), f
    shapes = env.pipeline.shapes
    assert obs.keys() == shapes.keys(), (what, obs.keys())
    for n, st in carry.obs_state.items():
      for k, x in st.items():
        assert torch.equal(x, fresh_obs[n][k]), f'{what}: buffer {n} {k}'
    for k, x in obs.items():
      assert tuple(x.shape) == (BATCH,) + shapes[k], (what, k, x.shape)
      assert bool(torch.isfinite(x).all()), f'{what}: observation {k}'
    assert bool((carry.substep == 1).all())
    log(f'# {what}@{BATCH}: launches per control step {per_step}, and '
        f'{per_reset} for the reset of every lane; every lane\'s state, '
        f'model_var and buffers as drawn')
    carry = obs = fresh = fresh_obs = None

    # the kernels at the task's layouts, held against their plain versions:
    # K2's float32 solves (the kernel's and the plain one alike) stop far
    # from float64 on many lanes where the cost is flat to float32
    # (`stop_gates`)
    k1_sub[what] = composer_k1(lk, what, *init_k1, got)
    init_k1 = None
    args, kw, iters, err, _, _ = k2_task_check(nk, what, m, lay, stepped,
                                               gates=stop_gates)
    b_ms, b_by = bound_ms(k2_bytes(BATCH, lay.nefc, m.nv),
                          newton_flops(lay.nefc, m.nv, solver.LS_ITERATIONS,
                                       iters))
    k2_sub[what] = dict(
        launches=got['newton_solve_batched'], max_abs_err=err,
        ms=cuda_ms(lambda: nk.newton_solve_batched(*args, lay=lay, **kw), 10),
        plain_ms=cuda_ms(lambda: nk.newton_solve_plain(
            *args, types=lay.types, **kw), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        max_iters=int(iters.max()), shape=[BATCH, lay.nefc, m.nv],
        launch_config=list(nk.launch_config(lay.nefc, m.nv, 0)),
        launches_per_control_step=per_step['newton_solve_batched'])
    log(f'# phase manipulation: K2 on {what}: {k2_sub[what]}')
    args = None
    gate_ctrl = controls(stepped, REF_LANES)
    if what in MANIPULATION_UNGATED:
      # the gated lanes, for `tools/reference_step_cpu.py --tasks
      # manipulation:<task> --states FILE`
      lanes = torch.arange(REF_LANES, device=dev)
      out = {f: x[lanes].cpu().numpy()
             for f, x in forward.state_items(forward.state_of(stepped))}
      out.update(ctrl=gate_ctrl.cpu().numpy(), lane=lanes.cpu().numpy())
      os.makedirs('chiprun_out', exist_ok=True)
      path = f'chiprun_out/reference_lanes_manipulation-{what}.npz'
      np.savez(path, **out)
      log(f'# phase manipulation: {what}: no gate (MANIPULATION_UNGATED); '
          f'its {REF_LANES} lanes written to {path}')
    else:
      t0 = time.perf_counter()
      reference_gate(what, m, stepped, gate_ctrl, env.n_sub_steps, lk)
      log(f'# phase reference: {what} {time.perf_counter() - t0:.1f} s')
    log(f'# phase manipulation: {what}: {time.perf_counter() - t_task:.1f} s')
  env = stepped = None
  torch.cuda.empty_cache()

  for r in rows:
    if r['name'] in ('cholesky_batched', 'chol_solve_batched',
                     'cho_solve_batched'):
      for what, sub in k1_sub.items():
        r[what] = dict(sub[r['name']], launches_per_control_step=per_steps[
            what][r['name']])
    if r['name'] == 'newton_solve_batched':
      r.update(k2_sub)
  log(f'# phase manipulation: {time.perf_counter() - t_phase:.1f} s; '
      f'env-steps/s {sps}; seconds per control step (with every lane\'s '
      f'reset) { {k: BATCH / v for k, v in sps.items()} }')
  return sps


def main() -> int:
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; the port\'s chip check needs one',
          file=sys.stderr)
    return 2
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  import numpy as np
  from dm_control_tpu_torch import suite
  from dm_control_tpu_torch._src import engine
  from dm_control_tpu_torch._src import forward
  from dm_control_tpu_torch._src import solver
  from dm_control_tpu_torch._src import efc
  from dm_control_tpu_torch.ops import build
  from dm_control_tpu_torch.ops import linalg_kernel as lk
  from dm_control_tpu_torch.ops import newton_kernel as nk
  from dm_control_tpu_torch.parallel import BatchedEnv
  from dm_control_tpu_torch.parallel import runner

  t_start = time.perf_counter()
  dev = torch.device('cuda')
  name = torch.cuda.get_device_name(0)
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()
  log(f'# torch {torch.__version__} cuda {torch.version.cuda} on {name}')

  # -- 1. build ---------------------------------------------------------------
  t0 = time.perf_counter()
  build.library()
  log(f'# phase build: {time.perf_counter() - t0:.1f} s (nvcc '
      f'{build.build_seconds if build.build_seconds is not None else 0:.1f} s)')
  for line in build.build_log.splitlines():
    if 'registers' in line or 'spill' in line:
      log('#   ' + line.strip())
  if '--train-only' in sys.argv[1:]:
    # phase train alone, without the contract's last line
    train_phase(lk, nk, [], dev)
    log(f'# chip_smoke.py --train-only: {time.perf_counter() - t_start:.1f} s')
    log(smi)
    return 0
  if '--manipulation-only' in sys.argv[1:]:
    # phase manipulation alone, without the contract's last line
    manipulation_phase(lk, nk, [], dev)
    log(f'# chip_smoke.py --manipulation-only: '
        f'{time.perf_counter() - t_start:.1f} s')
    log(smi)
    return 0
  if '--composer-only' in sys.argv[1:]:
    # phase composer alone, without the contract's last line
    composer_phase(lk, nk, [], dev)
    log(f'# chip_smoke.py --composer-only: '
        f'{time.perf_counter() - t_start:.1f} s')
    log(smi)
    return 0

  # -- 2. kernels against their plain versions ----------------------------------
  t_phase = time.perf_counter()
  gen = torch.Generator(device=dev)
  gen.manual_seed(0)

  def spd(n, g):
    a = torch.randn((BATCH, n, n), generator=g, device=dev)
    return a @ a.transpose(1, 2) + n * torch.eye(n, device=dev)

  # n = 3 and MAX_N draw from a generator of their own, so that every
  # later phase sees the same draws of `gen` as before they were added
  k1_gen = torch.Generator(device=dev)
  k1_gen.manual_seed(1)
  # the slice's sizes (pendulum's n = 1, reacher's, cartpole's and
  # acrobot's 2, hopper's 7) from the slice's generator
  s_gen = torch.Generator(device=dev)
  s_gen.manual_seed(SLICE_SEED)
  # the seventh slice's sizes (ball_in_cup's n = 4, swimmer6's 8, fish's
  # 13) and K2 inputs from a generator of their own
  s7_gen = torch.Generator(device=dev)
  s7_gen.manual_seed(SLICE7_SEED)
  # the eighth slice's K2 inputs from a generator of their own
  s8_gen = torch.Generator(device=dev)
  s8_gen.manual_seed(SLICE8_SEED)
  k1_err = {}
  for n, g in ((9, gen), (27, gen), (56, gen), (3, k1_gen),
               (lk.MAX_N, k1_gen), (1, s_gen), (2, s_gen), (7, s_gen),
               (4, s7_gen), (8, s7_gen), (13, s7_gen)):
    A = spd(n, g)
    b = torch.randn((BATCH, n), generator=g, device=dev)
    L_ref = lk.cholesky_plain(A)
    pairs = {
        'cholesky_batched': (lk.cholesky_batched(A), L_ref),
        'chol_solve_batched': (lk.chol_solve_batched(A, b),
                               lk.chol_solve_plain(A, b)),
        'cho_solve_batched': (lk.cho_solve_batched(L_ref, b),
                              lk.cho_solve_plain(L_ref, b)),
    }
    torch.cuda.synchronize()
    for k, (x, ref) in pairs.items():
      err = scaled_err(x, ref).max().item()
      k1_err[k, n] = (x - ref).abs().max().item()
      log(f'# phase kernels: {k} n={n}: max scaled err {err:.2e}')
      assert err <= 1e-4, f'{k} at n={n}: {err:.2e} > 1e-4'
    k1_bits(lk, A, b, pairs['cholesky_batched'][0],
            pairs['chol_solve_batched'][0],
            lk.cho_solve_batched(pairs['cholesky_batched'][0], b))

  task = suite.build_task('walker', 'walk')        # CUDA by default
  m = task.model
  lay = efc.layout(m)
  env = BatchedEnv(task, BATCH)
  state = env.reset()
  state, _ = env.rollout_fn(40)(state, gen)   # falls onto the floor
  k2_args, k2_kw, iters, k2_err, d, _ = k2_task_check(
      nk, 'walker-walk', m, lay, state.data)
  per_step = expected_launches(task)
  per_reset = reset_launches(task)

  # K2-ell on finger-spin inputs rich in contacts, same bounds (ell_gates).
  f_task = suite.build_task('finger', 'spin')      # CUDA by default
  finger_per_step = expected_launches(f_task)
  fm = f_task.model
  f_lay = efc.layout(fm)
  ell_args, f_d = finger_solver_inputs(fm, f_lay, BATCH, gen, dev)
  ell_kw = dict(niter=int(fm.opt.iterations), ls_iter=solver.LS_ITERATIONS,
                tol=solver.effective_tol(fm.opt.tolerance, torch.float32),
                meaninertia=float(fm.stat_meaninertia))
  nk.reset_launches()
  xe_k, fe_k, ell_iters = nk.newton_solve_batched(
      *ell_args, lay=f_lay, return_iters=True, **ell_kw)
  assert nk.LAUNCHES == {'newton_solve_batched': 0, 'newton_solve_ell': 1}
  plain_kw = dict(types=f_lay.types, ell_groups=f_lay.ell_groups)
  xe_p, fe_p, ell_iters_p = nk.newton_solve_plain(
      *ell_args, **plain_kw, return_iters=True, **ell_kw)
  xe_64, fe_64 = nk.newton_solve_plain(
      *[a.double() for a in ell_args], **plain_kw,
      **dict(ell_kw, tol=solver.effective_tol(fm.opt.tolerance,
                                              torch.float64)))
  on, zones = cone_zones(f_lay, ell_args[0].double(), ell_args[2].double(),
                         ell_args[5], xe_64)
  cones = on.sum(dim=1)
  f_cones = cone_counts(f_lay, on)
  lanes_on = float((cones > 0).double().mean())
  log(f'# phase kernels: newton_solve_ell B={BATCH} nefc={f_lay.nefc} '
      f'nv={fm.nv} ncg={n_cones(f_lay)}: lanes with an active '
      f'elliptic row {lanes_on:.4f}; active contacts {int(cones.sum())} '
      f'(mean {cones.double().mean().item():.2f} per lane), zones at the '
      f'float64 optimum top {zones["top"]:.4f} bottom '
      f'{zones["bottom"]:.4f} mid {zones["mid"]:.4f}; iterations mean '
      f'{ell_iters.float().mean().item():.2f} max {int(ell_iters.max())} '
      f'(plain float32: mean {ell_iters_p.float().mean().item():.2f} max '
      f'{int(ell_iters_p.max())}; lanes above 20: kernel '
      f'{int((ell_iters > 20).sum())}, plain {int((ell_iters_p > 20).sum())}; '
      f'lanes with the same count '
      f'{float((ell_iters == ell_iters_p).double().mean()):.4f})')
  assert lanes_on >= 0.9, 'K2-ell inputs: too few lanes in contact'
  assert zones['bottom'] >= 0.01 and zones['mid'] >= 0.01, zones
  assert torch.isfinite(fe_k).all() and torch.isfinite(xe_k).all()
  ell_gates('K2-ell', xe_k, xe_p, xe_64)
  for what, f, ref in (('kernel vs plain float32', fe_k, fe_p),
                       ('kernel vs plain float64', fe_k.double(), fe_64),
                       ('plain float32 vs plain float64', fe_p.double(),
                        fe_64)):
    err = lane_scaled_err(f, ref)
    log(f'#   K2-ell forces, {what} (record): lane-scaled mean '
        f'{err.mean().item():.2e} max {err.max().item():.2e}')
  ell_err = (xe_k - xe_p).abs().max().item()
  newton_launch(nk, 'newton_solve_ell', f_lay, fm.nv, BATCH)
  newton_bits(nk, 'newton_solve_ell', ell_args, f_lay, ell_kw,
              (xe_k, fe_k, ell_iters))
  # The optimum does not depend on the Hessian or on the line search's
  # phi'': a wrong cone block there changes only the path to it.  One
  # Newton iteration does.  With no line-search step it lands on
  # a - H^-1 grad (the cone blocks of H); with one, alpha = 1 - phi'(1) /
  # phi''(1) (the cone blocks of phi'').  Where the step is exact, phi'(1)
  # is rounding and alpha_n rounds to 1.0 in float32, which the guarded
  # Newton's strict bracket test sends to the bisection midpoint, 2.5 or
  # 0.5, lane by lane: so the one-step iterate is held only on the lanes
  # where the float64 line search moves alpha off 1, where phi'' sets it.
  one = {}
  for ls in (0, 1):
    kw1 = dict(ell_kw, niter=1, ls_iter=ls)
    one[ls] = (
        nk.newton_solve_batched(*ell_args, lay=f_lay, **kw1)[0],
        nk.newton_solve_plain(*ell_args, **plain_kw, **kw1)[0],
        nk.newton_solve_plain(
            *[a.double() for a in ell_args], **plain_kw,
            **dict(kw1, tol=solver.effective_tol(fm.opt.tolerance,
                                                 torch.float64)))[0])
  moved = lane_scaled_err(one[0][2], ell_args[6].double()).amax(dim=1) > 1e-3
  off = lane_scaled_err(one[1][2], one[0][2]).amax(dim=1) > 1e-3
  log(f'# phase kernels: newton_solve_ell, one Newton iteration: lanes '
      f'whose step moves qacc {float(moved.double().mean()):.4f}; lanes '
      f'whose one line-search step moves alpha off 1 '
      f'{float(off.double().mean()):.4f}')
  assert float(moved.double().mean()) >= 0.5, 'K2-ell one step: no step'
  assert float(off.double().mean()) >= 0.2, 'K2-ell one step: alpha at 1'
  ell_gates('K2-ell one iteration, no line search,', *one[0])
  ell_gates('K2-ell one iteration, one line-search step, alpha off 1,',
            *(x[off] for x in one[1]))

  # K2 at the slices' new layouts: cheetah's (6 limits, 54 pyramidal
  # contacts) and cartpole's (one slider-limit row) first impacts; then
  # point_mass's (2 wall limits), ball_in_cup's (the string's limit row
  # and 16 pyramidal contacts) and swimmer6's (5 joint limits, very soft)
  slice_tasks = {what: suite.build_task(*what.split('-'))
                 for what in SLICE_TASKS + STACKER_TASKS}
  # the tenth slice's K2 inputs from a generator of their own: humanoid_CMU
  # (nv 62, nefc 880: two dofs per lane, J in device memory) lying on or
  # pressed into the floor, escape on its terrain, fetch's ball against
  # the floor and a wall
  s10_gen = torch.Generator(device=dev)
  s10_gen.manual_seed(SLICE10_SEED)
  # the eleventh slice's K2 inputs (jaco with the target on a link and
  # fingers at their limits) from a generator of its own
  s11_gen = torch.Generator(device=dev)
  s11_gen.manual_seed(SLICE11_SEED)
  k2_slice = {}
  for what, g in (('cheetah-run', s_gen), ('cartpole-swingup', s_gen),
                  ('point_mass-easy', s7_gen), ('ball_in_cup-catch', s7_gen),
                  ('swimmer-swimmer6', s7_gen), ('humanoid-run', s8_gen),
                  ('quadruped-walk', s8_gen), ('humanoid_CMU-run', s10_gen),
                  ('quadruped-escape', s10_gen),
                  ('quadruped-fetch', s10_gen),
                  ('jaco-position_reacher_7DOF', s11_gen)):
    tm = slice_tasks[what].model
    impacts = impact_states(what, tm, BATCH, g, dev)
    topk = what in SLICE8_TASKS + SLICE10_TASKS + SLICE11_TASKS
    if topk:
      broadphase_bits(what, tm, impacts)
    k2_slice[what] = k2_task_check(
        nk, what, tm, efc.layout(tm), impacts)
    if topk:
      topk_live(what, tm, k2_slice[what][4])
  # one Newton iteration at the tenth slice's layouts, without a line
  # search (a - H^-1 grad: the Hessian, two dofs per lane at humanoid_CMU's)
  # and with one line-search step, held on the lanes where float64 moves
  # alpha off 1 (as finger's K2-ell above)
  for what in SLICE10_TASKS:
    s_args, s_kw = k2_slice[what][:2]
    s_lay = efc.layout(slice_tasks[what].model)
    tol64 = solver.effective_tol(slice_tasks[what].model.opt.tolerance,
                                 torch.float64)
    p_kw = dict(types=s_lay.types, ell_groups=s_lay.ell_groups)
    one = {}
    for ls in (0, 1):
      kw1 = dict(s_kw, niter=1, ls_iter=ls)
      one[ls] = (nk.newton_solve_batched(*s_args, lay=s_lay, **kw1)[0],
                 nk.newton_solve_plain(*s_args, **p_kw, **kw1)[0],
                 nk.newton_solve_plain(*[a.double() for a in s_args], **p_kw,
                                       **dict(kw1, tol=tol64))[0])
    off = lane_scaled_err(one[1][2], one[0][2]).amax(dim=1) > 1e-3
    log(f'# phase kernels: K2 on {what}, one Newton iteration: lanes whose '
        f'one line-search step moves alpha off 1 '
        f'{float(off.double().mean()):.4f}')
    float32_gates(f'K2 on {what}, one iteration, no line search,', *one[0])
    float32_gates(f'K2 on {what}, one iteration, one line-search step, '
                  f'alpha off 1,', *(x[off] for x in one[1]))
  # the twelfth slice: dog's solve past the Newton kernel's 64 dofs (nv
  # 79, nefc 1912; nv 85, nefc 3822) through the core with K1b, on states
  # standing or lying, fetch's ball beside the head, in the mouth, on the
  # target or over the body, from a generator of their own
  s12_gen = torch.Generator(device=dev)
  s12_gen.manual_seed(SLICE12_SEED)
  core_slice = {}
  for what in SLICE12_K1:
    t0 = time.perf_counter()
    tm = slice_tasks[what].model
    impacts = impact_states(what, tm, BATCH, s12_gen, dev)
    broadphase_bits(what, tm, impacts)
    core_slice[what] = core_task_check(nk, lk, what, tm, efc.layout(tm),
                                       impacts)
    log(f'# phase kernels: core on {what}: {time.perf_counter() - t0:.1f} s')
  # past the kernel's 64 dofs (dog's 85) K2 raises on the card and
  # launches nothing: there is no fallback to the plain version
  cmu_lay = efc.layout(slice_tasks['humanoid_CMU-run'].model)
  wide = torch.zeros((2, cmu_lay.nefc, nk.MAX_NV + 21), device=dev)
  nk.reset_launches()
  try:
    nk.newton_solve_batched(
        wide, torch.zeros((2, wide.shape[2], wide.shape[2]), device=dev),
        *[torch.zeros((2, cmu_lay.nefc), device=dev)] * 4,
        *[torch.zeros((2, wide.shape[2]), device=dev)] * 2, lay=cmu_lay,
        niter=1, ls_iter=1, tol=1e-8, meaninertia=1.0)
    raise AssertionError(f'K2 took nv={wide.shape[2]} on the card')
  except ValueError as e:
    assert f'1..{nk.MAX_NV}' in str(e), e
    log(f'# phase kernels: newton_solve_batched at nv={wide.shape[2]} on the '
        f'card raises: {e}')
  assert sum(nk.LAUNCHES.values()) == 0

  # K2-ell at the ninth slice's layouts (nefc 392-1166, nv 11-20, 128-386
  # condim-3 cones; stack_4's one environment per block), on states with
  # the props on the floor, stacked or in the slot, from a generator of
  # their own
  s9_gen = torch.Generator(device=dev)
  s9_gen.manual_seed(SLICE9_SEED)
  ell_slice = {}
  for what in SLICE9_TASKS + STACKER_TASKS:
    tm = slice_tasks[what].model
    ell_slice[what] = k2_task_check(
        nk, what, tm, efc.layout(tm), impact_states(what, tm, BATCH, s9_gen,
                                                    dev))

  # K2-ell's C = 6 instantiation (condim-3, -4 and -6 cones in one
  # layout) at the cone model's layouts: one copy (nv 18, nefc 48, 11
  # cones, one dof per lane) and two (nv 36, nefc 180, 41 cones, two dofs
  # per lane), on `cone_states` from a numpy generator of their own, where
  # every condim's cones are live; converged and after one Newton
  # iteration.  The condim-6 ball's rolling friction (row scale
  # 0.0001 / 0.7) leaves the cost flat to float32 along a direction on
  # some lanes, where float32 solves stop far from float64 with costs
  # float32 cannot tell from the optimum's, so the converged solves are
  # held lane by lane (`stop_gates`: K2's bounds on every other lane), and
  # the one-iteration ones by `float32_gates`.
  cone_models = {f'cones x{c}': engine.load_model_from_string(cones_xml(c))
                 for c in (1, 2)}
  s11_rng = np.random.RandomState(SLICE11_SEED)
  for what, cm in cone_models.items():
    c_lay = efc.layout(cm)
    q, v = cone_states(cm, BATCH, s11_rng)
    d0 = forward.make_data(cm, BATCH, torch.float32, dev).replace(
        qpos=torch.tensor(q, dtype=torch.float32, device=dev),
        qvel=torch.tensor(v, dtype=torch.float32, device=dev))
    ell_slice[what] = k2_task_check(nk, what, cm, c_lay, d0,
                                    gates=stop_gates)
    c_args, c_kw = ell_slice[what][:2]
    for k, (rows, _, _) in sorted(c_lay.ell_groups.items()):
      live = c_args[5][:, torch.as_tensor(rows[:, 0], device=dev)] > 0
      log(f'# phase kernels: {what}: condim-{k} cones live on '
          f'{float(live.any(dim=1).double().mean()):.4f} of the lanes; each '
          f'cone\'s share '
          f'{[round(x, 3) for x in live.double().mean(0).tolist()]}')
      assert float(live.any(dim=1).double().mean()) >= 0.25, (
          f'{what}: condim-{k} cones live on too few lanes')
    p_kw = dict(types=c_lay.types, ell_groups=c_lay.ell_groups)
    tol64 = solver.effective_tol(cm.opt.tolerance, torch.float64)
    one = {}
    for ls in (0, 1):
      kw1 = dict(c_kw, niter=1, ls_iter=ls)
      one[ls] = (nk.newton_solve_batched(*c_args, lay=c_lay, **kw1)[0],
                 nk.newton_solve_plain(*c_args, **p_kw, **kw1)[0],
                 nk.newton_solve_plain(*[a.double() for a in c_args], **p_kw,
                                       **dict(kw1, tol=tol64))[0])
    off = lane_scaled_err(one[1][2], one[0][2]).amax(dim=1) > 1e-3
    log(f'# phase kernels: K2-ell on {what}, one Newton iteration: lanes '
        f'whose one line-search step moves alpha off 1 '
        f'{float(off.double().mean()):.4f}')
    float32_gates(f'K2-ell on {what}, one iteration, no line search,',
                  *one[0])
    float32_gates(f'K2-ell on {what}, one iteration, one line-search step, '
                  f'alpha off 1,', *(x[off] for x in one[1]))

  # K1 at humanoid's n = 27 and quadruped's 22 on their initial states
  # (reset through the tasks' collision-free draws and settling), at
  # manipulator's n = 11 and stacker's 14 and 20 on theirs, and at
  # humanoid_CMU's n = 62 and fetch's 28 on theirs.  Their
  # mass matrices are far worse conditioned than the random draws above
  # (a float32 solve of humanoid's moves ~1e-3 of x with the order of its
  # sums), so each mode is held as K2 is (`ell_gates`): K2's bounds on the
  # lane-scaled error against the plain float32 version and against the
  # float64 one, the latter at no more than twice plain float32's own
  # error where plain float32 misses them; these are the errors their
  # timing rows report
  s8_init = {what: BatchedEnv(slice_tasks[what], BATCH).reset(seed=0).data
             for what in SLICE8_TASKS + SLICE9_K1 + SLICE10_K1 + SLICE11_K1
             + SLICE12_K1}
  # the cone model's n = 18 and 36 on its kernel-phase states
  s8_init.update({what: ell_slice[what][4] for what in cone_models})
  for what, s_d in s8_init.items():
    A, b = s_d.qM.contiguous(), s_d.qfrc_smooth.contiguous()
    n = A.shape[1]
    L_ref = lk.cholesky_plain(A)
    A64, b64, L64 = A.double(), b.double(), L_ref.double()
    triples = {
        'cholesky_batched': (lk.cholesky_batched(A), L_ref,
                             lk.cholesky_plain(A64)),
        'chol_solve_batched': (lk.chol_solve_batched(A, b),
                               lk.chol_solve_plain(A, b),
                               lk.chol_solve_plain(A64, b64)),
        'cho_solve_batched': (lk.cho_solve_batched(L_ref, b),
                              lk.cho_solve_plain(L_ref, b),
                              lk.cho_solve_plain(L64, b64)),
    }
    for k, (x, ref, x_64) in triples.items():
      k1_err[k, n] = (x - ref).abs().max().item()
      ell_gates(f'{k} n={n} on {what}\'s initial states', x.flatten(1),
                ref.flatten(1), x_64.flatten(1))
    k1_bits(lk, A, b, triples['cholesky_batched'][0],
            triples['chol_solve_batched'][0],
            lk.cho_solve_batched(triples['cholesky_batched'][0], b))

  log(f'# phase kernels: {time.perf_counter() - t_phase:.1f} s')
  # -- 3. against the float64 path ---------------------------------------------
  # REF_LANES lanes of walker's state after the 40-step rollout, and of the
  # finger-spin lanes in contact; the first 64 lanes' controls from `gen`
  t0 = time.perf_counter()
  ref_gen = torch.Generator(device=dev)
  ref_gen.manual_seed(REF_SEED)
  for what, model, data, n_sub in (
      ('walker-walk', m, state.data, env.n_sub_steps),
      ('finger-spin', fm, f_d, f_task.n_sub_steps())):
    ctrl = reference_controls(gen, ref_gen, model.nu, REF_LANES, dev)
    reference_gate(what, model, data, ctrl, n_sub, lk)
  log(f'# phase reference: {time.perf_counter() - t0:.1f} s')

  # -- 4. the main path: walker-walk@4096 rollout, three runs -----------------
  run = env.rollout_fn(CONTROL_STEPS)
  w_sps = []
  for i in range(WALKER_RUNS):
    state = env.reset(seed=i)
    torch.cuda.synchronize()
    lk.reset_launches()
    nk.reset_launches()
    resets0 = env.reset_calls
    t0 = time.perf_counter()
    state, rewards = run(state, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(lk.LAUNCHES, **nk.LAUNCHES)
    resets = env.reset_calls - resets0
    w_sps.append(BATCH * CONTROL_STEPS / dt)
    log(f'# phase rollout: walker-walk@{BATCH} run {i} x {CONTROL_STEPS} '
        f'control steps in {dt:.2f} s ({w_sps[-1]:.1f} env-steps/s); '
        f'auto-reset calls {resets}; launches {launches}; mean reward '
        f'{rewards.mean().item():.4f}')
    for f in forward._STATE_FIELDS[:-1]:
      x = getattr(state.data, f)
      assert x.dtype == torch.bool or torch.isfinite(x).all(), f'{f} not finite'
    assert tuple(rewards.shape) == (CONTROL_STEPS, BATCH)
    assert bool(((rewards >= 0) & (rewards <= 1)).all()), 'reward outside [0,1]'
    for k, n in launches.items():
      want = per_step[k] * CONTROL_STEPS + per_reset[k] * resets
      assert n == want, f'{k}: {n} launches, expected {want}'
  log(f'# walker-walk@{BATCH} env-steps/s: '
      f'{sorted(w_sps)[len(w_sps) // 2]:.1f} (median of {WALKER_RUNS} runs: '
      f'{", ".join(f"{v:.1f}" for v in w_sps)})')

  # -- 4b. the main path: finger-spin@4096 rollout, three runs ------------------
  f_env = BatchedEnv(f_task, BATCH)
  f_run = f_env.rollout_fn(CONTROL_STEPS)
  f_sps = []
  for i in range(FINGER_RUNS):
    state = f_env.reset(seed=i)
    torch.cuda.synchronize()
    lk.reset_launches()
    nk.reset_launches()
    resets0 = f_env.reset_calls
    t0 = time.perf_counter()
    state, rewards = f_run(state, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    f_launches = dict(lk.LAUNCHES, **nk.LAUNCHES)
    f_sps.append(BATCH * CONTROL_STEPS / dt)
    log(f'# phase rollout: finger-spin@{BATCH} run {i} x {CONTROL_STEPS} '
        f'control steps in {dt:.2f} s ({f_sps[-1]:.1f} env-steps/s); '
        f'launches {f_launches}; mean reward {rewards.mean().item():.4f}')
    for f, x in forward.state_items(forward.state_of(state.data)):
      assert x.dtype == torch.bool or torch.isfinite(x).all(), f'{f} not finite'
    assert tuple(rewards.shape) == (CONTROL_STEPS, BATCH)
    assert bool(((rewards >= 0) & (rewards <= 1)).all()), 'finger reward'
    assert f_env.reset_calls == resets0        # resets come from the pool
    for k, n in f_launches.items():
      want = finger_per_step[k] * CONTROL_STEPS
      assert n == want, f'finger {k}: {n} launches, expected {want}'
  log(f'# finger-spin@{BATCH} env-steps/s: '
      f'{sorted(f_sps)[len(f_sps) // 2]:.1f} (median of {FINGER_RUNS} runs: '
      f'{", ".join(f"{v:.1f}" for v in f_sps)})')
  launches['newton_solve_ell'] = f_launches['newton_solve_ell']

  # -- 4c. finger-spin's reset pool on the card -------------------------------
  # An episode limit of 0.06 s (3 control steps) sends every lane through
  # the pool at the third step: each lane's integration state is then pool
  # entry runner.pool_index(0, lane, B), and init_states is not called.
  p_env = BatchedEnv(f_task, BATCH, time_limit=0.06)
  state = p_env.reset(seed=FINGER_RUNS)
  torch.cuda.synchronize()
  lk.reset_launches()
  nk.reset_launches()
  resets0 = p_env.reset_calls
  state, rewards = p_env.rollout_fn(3)(state, gen)
  torch.cuda.synchronize()
  p_launches = dict(lk.LAUNCHES, **nk.LAUNCHES)
  taken = runner.pool_index(torch.zeros_like(state.episode_id),
                            torch.arange(BATCH, device=dev), BATCH)
  log(f'# phase rollout: finger-spin@{BATCH} x 3 control steps, episode '
      f'limit 0.06 s: episodes ended {int(state.episode_id.sum())}; '
      f'init_states resets {p_env.reset_calls - resets0}; launches '
      f'{p_launches}')
  assert bool((state.episode_id == 1).all() and (state.step_count == 0).all())
  assert p_env.reset_calls == resets0, 'finger reset outside the pool'
  pool = dict(forward.state_items(state.reset_pool))
  for f, x in forward.state_items(forward.state_of(state.data)):
    assert torch.equal(x, pool[f][taken]), f'pool {f}'
  assert bool(((rewards >= 0) & (rewards <= 1)).all()), 'finger reward'
  for k, n in p_launches.items():
    want = finger_per_step[k] * 3
    assert n == want, f'finger pool run {k}: {n} launches, expected {want}'

  # -- 4d. the cone model: 4096 lanes dropped, CONES_STEPS physics steps -------
  # The bodies of `cone_states` (generator SLICE11_SEED + 1) raised 2 to
  # 20 cm and dropped: every state finite, one K2-ell launch (and no K2)
  # per physics step, each condim's cones live on some lane at the end;
  # then the reference gate on its first REF_LANES lanes (one physics
  # step; the model has no actuators).
  cm = cone_models['cones x1']
  q, v = cone_states(cm, BATCH, np.random.RandomState(SLICE11_SEED + 1))
  drop = np.random.RandomState(SLICE11_SEED + 2)
  for body in range(3):
    q[:, 7 * body + 2] += drop.uniform(0.02, 0.2, BATCH)
  c_d = forward.forward(cm, forward.make_data(cm, BATCH, torch.float32,
                                              dev).replace(
      qpos=torch.tensor(q, dtype=torch.float32, device=dev),
      qvel=torch.tensor(v, dtype=torch.float32, device=dev)))
  torch.cuda.synchronize()
  lk.reset_launches()
  nk.reset_launches()
  t0 = time.perf_counter()
  c_d = forward.substeps(cm, c_d, CONES_STEPS)
  torch.cuda.synchronize()
  dt = time.perf_counter() - t0
  cone_launches = dict(lk.LAUNCHES, **nk.LAUNCHES)
  c_lay = efc.layout(cm)
  live = {k: float((c_d.efc_active[:, torch.as_tensor(rows[:, 0], device=dev)]
                    .any(dim=1)).double().mean())
          for k, (rows, _, _) in sorted(c_lay.ell_groups.items())}
  log(f'# phase cones: cone model@{BATCH} x {CONES_STEPS} physics steps in '
      f'{dt:.2f} s ({BATCH * CONES_STEPS / dt:.1f} lane-steps/s); launches '
      f'{cone_launches}; lanes with a live cone at the end, by condim {live}')
  for f, x in forward.state_items(forward.state_of(c_d)):
    assert x.dtype == torch.bool or torch.isfinite(x).all(), (
        f'cone model: {f} not finite')
  want = {k: 0 for k in cone_launches}
  want.update(cholesky_batched=CONES_STEPS + 1, cho_solve_batched=CONES_STEPS,
              newton_solve_ell=CONES_STEPS)
  assert cone_launches == want, (cone_launches, want)
  assert all(share > 0 for share in live.values()) and len(live) == 3, live
  t0 = time.perf_counter()
  reference_gate('cones x1', cm, c_d, torch.zeros((REF_LANES, 0), device=dev),
                 1, lk)
  log(f'# phase reference: cones x1 {time.perf_counter() - t0:.1f} s')

  # -- 5. timing at the main path's shapes ----------------------------------------
  t_phase = time.perf_counter()
  # the kernel phase's float64 solves at dog's layouts leave the caching
  # allocator holding most of the card, and cuSOLVER's handle (created by
  # the first library call below) is allocated outside it
  torch.cuda.empty_cache()
  lib = build.library()
  stream = torch.cuda.current_stream().cuda_stream
  rows = []

  # wrapper calls whose CUDA kernels and device time one torch.profiler
  # session measures (`device_kernels`), and the rows that take them
  profiled, profiled_rows = {}, {}

  def k1_rows(tag, A, b, counts):
    """K1a/b/c timings on task `tag`'s (B, n, n) qM and (B, n) vector; the
    `kernel_ms` entries run the ctypes entries on pre-made buffers.  Their
    device time is measured later, with every other profiled call."""
    B, n, _ = A.shape
    cfg = lk.launch_config(n)
    L = lk.cholesky_batched(A)
    l_out, x_out = torch.empty_like(A), torch.empty_like(b)
    mat, vec = B * n * n * 4, B * n * 4
    calls = {
        'cholesky_batched': (
            lambda: lk.cholesky_batched(A), lambda: lk.cholesky_plain(A),
            lambda: torch.linalg.cholesky(A),
            lambda: lib.dmc_cholesky(A.data_ptr(), l_out.data_ptr(), n, B,
                                     *cfg, stream),
            2 * mat, B * n ** 3 / 3),
        'chol_solve_batched': (
            lambda: lk.chol_solve_batched(A, b),
            lambda: lk.chol_solve_plain(A, b),
            lambda: torch.linalg.solve(A, b),
            lambda: lib.dmc_chol_solve(A.data_ptr(), b.data_ptr(),
                                       x_out.data_ptr(), n, B, *cfg, stream),
            mat + 2 * vec, B * (n ** 3 / 3 + 2 * n * n)),
        'cho_solve_batched': (
            lambda: lk.cho_solve_batched(L, b),
            lambda: lk.cho_solve_plain(L, b),
            lambda: torch.cholesky_solve(b[..., None], L),
            lambda: lib.dmc_cho_solve(L.data_ptr(), b.data_ptr(),
                                      x_out.data_ptr(), n, B, *cfg, stream),
            mat + 2 * vec, B * 2 * n * n)}
    out = {}
    for k, (fn, plain, library, entry, nbytes, flops) in calls.items():
      build.check(entry(), k)
      b_ms, b_by = bound_ms(nbytes, flops)
      out[k] = dict(
          launches=counts[k], max_abs_err=k1_err[k, n], ms=cuda_ms(fn, 50),
          plain_ms=cuda_ms(plain, 5), bound_ms=b_ms, bound_by=b_by,
          library_ms=cuda_ms(library, 50), kernel_ms=cuda_ms(entry, 50),
          shape=[B, n, n], envs=cfg[0], threads=cfg[1], smem_bytes=cfg[2])
      key = f'{k} n={n} ({tag})'
      profiled[key] = (fn, 20)
      profiled_rows[key] = out[k]
    return out

  walker_k1 = k1_rows('walker-walk', d.qM.contiguous(),
                      d.qfrc_smooth.contiguous(), launches)
  finger_k1 = k1_rows('finger-spin', f_d.qM.contiguous(),
                      f_d.qfrc_smooth.contiguous(), f_launches)
  # the slices' K1 sizes on their tasks' initial states: pendulum's n = 1,
  # reacher's 2, hopper's 7, ball_in_cup's 4, swimmer6's 8 and fish's 13
  # (their launches, those of the task's run in phase slice, are filled in
  # after it: this phase runs first, while torch.profiler still sees every
  # kernel of a session)
  slice_k1 = {}
  for what in ('pendulum-swingup', 'reacher-easy', 'hopper-hop',
               'ball_in_cup-catch', 'swimmer-swimmer6', 'fish-swim',
               'humanoid-run', 'quadruped-walk') + SLICE9_K1 + SLICE10_K1 + (
                   SLICE11_K1 + tuple(cone_models) + SLICE12_K1):
    s_d = s8_init[what] if what in s8_init else BatchedEnv(slice_tasks[what],
                                          BATCH).reset(seed=0).data
    slice_k1[what] = k1_rows(what, s_d.qM.contiguous(),
                             s_d.qfrc_smooth.contiguous(),
                             dict.fromkeys(per_step))

  def row(k, fn, plain, library, nbytes, flops, err, reps=50, plain_reps=5,
          **extra):
    ms = cuda_ms(fn, reps)
    b_ms, b_by = bound_ms(nbytes, flops)
    rows.append(dict(
        name=k, route='cuda', source=SOURCES[k], replaces=REPLACES[k],
        launches=launches[k], max_abs_err=err, ms=ms,
        plain_ms=cuda_ms(plain, plain_reps), bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(library, reps) if library is not None else None,
        **extra))
    log(f'# phase timing: {k}: {ms:.6g} ms per call, bound {b_ms:.6g} ms '
        f'({b_by}), plain {rows[-1]["plain_ms"]:.6g} ms, library '
        f'{rows[-1]["library_ms"]} ms; {extra or ""}')

  # K2 at the slices' layouts (the first impacts or limits of cheetah,
  # cartpole, point_mass, ball_in_cup and swimmer6), with the launches of
  # that task's rollout run
  k2_sub = {}
  for what, (s_args, s_kw, s_iters, s_err, _, _) in k2_slice.items():
    s_m = slice_tasks[what].model
    s_lay = efc.layout(s_m)
    b_ms, b_by = bound_ms(
        k2_bytes(BATCH, s_lay.nefc, s_m.nv),
        newton_flops(s_lay.nefc, s_m.nv, solver.LS_ITERATIONS, s_iters))
    solve = (lambda s_args=s_args, s_lay=s_lay, s_kw=s_kw:
             nk.newton_solve_batched(*s_args, lay=s_lay, **s_kw))
    k2_sub[row_key(what)] = dict(
        launches=None, max_abs_err=s_err, ms=cuda_ms(solve, 10),
        plain_ms=cuda_ms(lambda: nk.newton_solve_plain(
            *s_args, types=s_lay.types, **s_kw), 2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        max_iters=int(s_iters.max()), shape=[BATCH, s_lay.nefc, s_m.nv])
    key = f'newton_solve_batched on {what}'
    profiled[key] = (solve, 5)
    profiled_rows[key] = k2_sub[row_key(what)]

  # K2-ell at the ninth slice's layouts, with the launches of that task's
  # rollout run; bytes and FLOPs as for finger's row below
  ell_sub = {}
  for what, (s_args, s_kw, s_iters, s_err, _, s_cones) in ell_slice.items():
    s_m = (cone_models[what] if what in cone_models
           else slice_tasks[what].model)
    s_lay = efc.layout(s_m)
    s_ncg = n_cones(s_lay)
    b_ms, b_by = bound_ms(
        ell_bytes(s_lay, BATCH, s_m.nv),
        newton_flops(s_lay.nefc, s_m.nv, solver.LS_ITERATIONS, s_iters,
                     cones={k: c.to(s_iters.device)
                            for k, c in s_cones.items()}))
    solve = (lambda s_args=s_args, s_lay=s_lay, s_kw=s_kw:
             nk.newton_solve_batched(*s_args, lay=s_lay, **s_kw))
    warps, smem = nk.launch_config(s_lay.nefc, s_m.nv, s_ncg,
                                   nk.cone_width(s_lay))
    ell_sub[what] = dict(
        launches=None, max_abs_err=s_err, ms=cuda_ms(solve, 5),
        plain_ms=cuda_ms(lambda: nk.newton_solve_plain(
            *s_args, types=s_lay.types, ell_groups=s_lay.ell_groups,
            **s_kw), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        max_iters=int(s_iters.max()),
        shape=[BATCH, s_lay.nefc, s_m.nv, s_ncg], warps=warps,
        smem_bytes=smem)
    key = f'newton_solve_ell on {what}'
    profiled[key] = (solve, 3)
    profiled_rows[key] = ell_sub[what]

  # the core (K1b inside) at dog's layouts: ms per call of the whole route
  # (host work and every CUDA kernel of its loop included), its K1b
  # launches per call and its bound (the Newton solve's bytes and FLOPs for
  # these lanes' iterations)
  core_sub = {}
  for what, (c_args, c_kw, c_iters, c_err, _, c_loops) in core_slice.items():
    c_m = slice_tasks[what].model
    c_lay = efc.layout(c_m)
    b_ms, b_by = bound_ms(
        k2_bytes(BATCH, c_lay.nefc, c_m.nv),
        newton_flops(c_lay.nefc, c_m.nv, solver.LS_ITERATIONS, c_iters))
    core_sub[what] = dict(
        launches=None, k1b_launches_per_call=c_loops, max_abs_err=c_err,
        ms=cuda_ms(lambda c_args=c_args, c_lay=c_lay, c_kw=c_kw:
                   nk.newton_solve_core(*c_args, lay=c_lay, **c_kw), 3),
        plain_ms=cuda_ms(lambda c_args=c_args, c_lay=c_lay, c_kw=c_kw:
                         nk.newton_solve_plain(*c_args, types=c_lay.types,
                                               **c_kw), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        max_iters=int(c_iters.max()), shape=[BATCH, c_lay.nefc, c_m.nv])
    log(f'# phase timing: core (K1b inside) on {what}: {core_sub[what]}')

  # every profiled call's CUDA kernels (one per call) and device time
  for key, (kernels, device_ms) in device_kernels(profiled).items():
    profiled_rows[key].update(device_ms=device_ms, kernels_per_call=kernels)
    log(f'# phase timing: {key}: {profiled_rows[key]}')
  for k in ('cholesky_batched', 'chol_solve_batched', 'cho_solve_batched'):
    rows.append(dict(name=k, route='cuda', source=SOURCES[k],
                     replaces=REPLACES[k], **walker_k1[k],
                     finger=finger_k1[k],
                     **{row_key(t): r[k] for t, r in slice_k1.items()},
                     **({'core': core_sub} if k == 'chol_solve_batched'
                        else {})))
  k1_step = {what: sum(per_step[k] * walker_k1[k][what]
                       for k in walker_k1)
             for what in ('ms', 'kernel_ms', 'device_ms')}
  log(f'# phase timing: walker K1 per control step (11 K1a + 10 K1b + 10 '
      f'K1c): wrapper {k1_step["ms"]:.6g} ms, ctypes launches '
      f'{k1_step["kernel_ms"]:.6g} ms, device {k1_step["device_ms"]:.6g} ms')

  nv, nefc = m.nv, lay.nefc
  row('newton_solve_batched',
      lambda: nk.newton_solve_batched(*k2_args, lay=lay, **k2_kw),
      lambda: nk.newton_solve_plain(*k2_args, types=lay.types, **k2_kw),
      None, k2_bytes(BATCH, nefc, nv),
      newton_flops(nefc, nv, solver.LS_ITERATIONS, iters), k2_err,
      reps=10, plain_reps=2, max_iters=int(iters.max()), **k2_sub)
  f_nv, f_nefc = fm.nv, f_lay.nefc
  row('newton_solve_ell',
      lambda: nk.newton_solve_batched(*ell_args, lay=f_lay, **ell_kw),
      lambda: nk.newton_solve_plain(*ell_args, **plain_kw, **ell_kw),
      None, ell_bytes(f_lay, BATCH, f_nv),
      newton_flops(f_nefc, f_nv, solver.LS_ITERATIONS, ell_iters,
                   cones={k: c.to(ell_iters.device)
                          for k, c in f_cones.items()}), ell_err,
      reps=10, plain_reps=2, max_iters=int(ell_iters.max()), **ell_sub)

  log(f'# phase timing: {time.perf_counter() - t_phase:.1f} s')
  # the kernel and timing phases' states and solver inputs are not read
  # again (their keys are): dog's hold several GB each, and dog-fetch's
  # rollout needs ~41 GB of the card
  del s8_init, impacts, s_d, s_args, c_args
  k2_slice, ell_slice, core_slice = (dict.fromkeys(x) for x in (
      k2_slice, ell_slice, core_slice))
  profiled.clear()
  torch.cuda.empty_cache()

  # -- 6. the slices: eleven more tasks, reference gates, resets -------------
  # Each task: run SLICE_RUN, a reset and `slice_steps` control steps of
  # BATCH lanes, states finite, rewards in its range, every kernel launched
  # exactly `expected_launches` times per control step (no episode ends);
  # then the reference gate on REF_LANES lanes of the run's final states,
  # each task's controls from a generator of its own.
  slice_launches, slice_core = {}, {}
  t_slice = time.perf_counter()
  for i_task, what in enumerate(SLICE_TASKS):
    s_task = slice_tasks[what]
    # the last task's environment and states go before this one's come,
    # and the blocks they held back to the card
    s_env = state = rewards = None
    torch.cuda.empty_cache()
    s_env = BatchedEnv(s_task, BATCH)
    want = expected_launches(s_task)
    steps = slice_steps(what)
    # the task's own peak: allocated memory at its start (what earlier
    # phases keep alive) and the largest while it runs
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    state, rewards, t_reset, dt = slice_run(
        s_env, i_task, SLICE_RUN, dev,
        after_reset=lambda: (lk.reset_launches(), nk.reset_launches()))
    got = dict(lk.LAUNCHES, **nk.LAUNCHES)
    core = dict(nk.CORE_LOOPS)
    log(f'# phase slice: {what}@{BATCH} run {SLICE_RUN}: reset {t_reset:.2f} '
        f's; {steps} control steps in {dt:.2f} s ({BATCH * steps / dt:.1f} '
        f'env-steps/s); launches {got}; core {core}; mean reward '
        f'{rewards.mean().item():.4f}; peak memory allocated '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, '
        f'{base_bytes / 2 ** 30:.2f} GiB of it held before the task')
    for f, x in forward.state_items(forward.state_of(state.data)):
      assert x.dtype == torch.bool or torch.isfinite(x).all(), (
          f'{what}: {f} not finite')
    assert tuple(rewards.shape) == (steps, BATCH)
    r_lo, r_hi = REWARD_RANGE.get(what, (0.0, 1.0))
    assert bool(((rewards >= r_lo) & (rewards <= r_hi)).all()), (
        f'{what}: reward outside [{r_lo}, {r_hi}]')
    assert not bool(state.episode_id.any()), f'{what}: an episode ended'
    # the core's K1b launches: exactly one per iteration of its loops
    assert core['calls'] == core_calls(s_task) * steps, (what, core)
    want_run = {k: v * steps for k, v in want.items()}
    want_run['chol_solve_batched'] += core['loops']
    for k, n in got.items():
      assert n == want_run[k], (
          f'{what} {k}: {n} launches, expected {want_run[k]}')
    slice_launches[what] = got
    slice_core[what] = core
    log(f'# {what}@{BATCH}: launches per control step {want}'
        + (f' and the core\'s K1b launches ({core})' if core['calls']
           else ''))
    if what in UNGATED_TASKS:
      log(f'# phase reference: {what}: no gate (UNGATED_TASKS)')
      continue
    t0 = time.perf_counter()
    m_s = s_task.model
    if s_task.before_step is None:
      ctrl = slice_controls(i_task, m_s.nu, REF_LANES, dev)
    else:
      # the task's actions, uniform in its bounds, made controls as a step
      # makes them (jaco: joint targets within 0.1 of the current angles)
      lo, hi = (torch.as_tensor(b, dtype=torch.float32, device=dev)
                for b in s_task.action_bounds())
      u = slice_controls(i_task, lo.shape[0], REF_LANES, dev)
      head = state.data.replace(
          qpos=state.data.qpos[:REF_LANES],
          model_var={k: v[:REF_LANES]
                     for k, v in (state.data.model_var or {}).items()})
      ctrl = s_task.before_step(m_s, head, lo + (hi - lo) * (u + 1) / 2).ctrl
    reference_gate(what, m_s, state.data, ctrl,
                   GATE_SUBSTEPS.get(what, s_task.n_sub_steps()), lk)
    if what == 'quadruped-escape':
      rangefinder_check(m_s, suite.build_task(*what.split('-'),
                                              device='cpu').model, state.data)
    log(f'# phase reference: {what} {time.perf_counter() - t0:.1f} s')

  # Episode limits that end every lane's episode: reacher's, swimmer's and
  # fish's fresh lanes hold the target geom_pos that init_states drew for
  # them (the same generator state drawn again); finger-turn's, cheetah's,
  # ball_in_cup's, humanoid's, quadruped's, insert_peg's and the tenth
  # slice's lanes hold their reset pool entry, its model_var (finger-turn's
  # target site_pos, insert_peg's target and slot body_pos and body_quat,
  # escape's hfield_data) included, and init_states is not called.
  for what, limit_steps in (('reacher-easy', 2), ('finger-turn_easy', 3),
                            ('cheetah-run', 2), ('ball_in_cup-catch', 2),
                            ('swimmer-swimmer6', 2), ('fish-swim', 2),
                            ('humanoid-run', 2), ('quadruped-walk', 2),
                            ('manipulator-insert_peg', 2),
                            ('humanoid_CMU-run', 2), ('quadruped-escape', 2),
                            ('quadruped-fetch', 2)):
    s_task = slice_tasks[what]
    r_env = BatchedEnv(s_task, BATCH, time_limit=limit_steps * (
        s_task.model.opt.timestep * s_task.n_sub_steps()))
    state = r_env.reset(seed=SLICE_RUN + 1)
    old = forward.state_of(state.data)['model_var']
    state, _ = r_env.rollout_fn(limit_steps - 1)(state, s_gen)
    drawn = r_env.generator.get_state()
    torch.cuda.synchronize()
    lk.reset_launches()
    nk.reset_launches()
    resets0 = r_env.reset_calls
    state, rewards = r_env.rollout_fn(1)(state, s_gen)
    torch.cuda.synchronize()
    got = dict(lk.LAUNCHES, **nk.LAUNCHES)
    assert bool((state.episode_id == 1).all() and (state.step_count == 0).all())
    assert bool(((rewards >= 0) & (rewards <= 1)).all()), f'{what} reward'
    want = expected_launches(s_task)
    st = forward.state_of(state.data)
    if s_task.expensive_init:
      assert r_env.reset_calls == resets0, f'{what}: reset outside the pool'
      taken = runner.pool_index(torch.zeros_like(state.episode_id),
                                torch.arange(BATCH, device=dev), BATCH)
      pool = dict(forward.state_items(state.reset_pool))
      for f, x in forward.state_items(st):
        assert torch.equal(x, pool[f][taken]), f'{what}: pool {f}'
      ref_mv = {k: v[taken] for k, v in state.reset_pool['model_var'].items()}
    else:
      assert r_env.reset_calls == resets0 + 1
      r_env.generator.set_state(drawn)
      fresh = forward.state_of(r_env.init_states(BATCH))
      for f in ('qpos', 'model_var.geom_pos'):
        assert torch.equal(dict(forward.state_items(st))[f],
                           dict(forward.state_items(fresh))[f]), (
            f'{what}: {f} is not its fresh draw')
      ref_mv = fresh['model_var']
      want = {k: v + n for (k, v), n in zip(
          want.items(), reset_launches(s_task).values())}
    for k, n in got.items():
      assert n == want[k], f'{what} reset step {k}: {n} launches, want {want[k]}'
    for k, v in st['model_var'].items():
      assert torch.equal(v, ref_mv[k])
      moved = (v != old[k]).flatten(1).any(dim=1)
      assert bool(moved.all()), f'{what}: a lane kept its old {k}'
    log(f'# phase slice: {what}@{BATCH}, episode limit {limit_steps} '
        f'control steps: every lane reset ({"reset pool" if s_task.expensive_init else "fresh init_states"}); '
        f'model_var {sorted(st["model_var"])} per lane as drawn; launches '
        f'{got}')
  log(f'# phase slice: {time.perf_counter() - t_slice:.1f} s')

  # (stacker runs in phase kernels only: its entries keep launches None)
  for what, r in slice_k1.items():
    for k in r:
      if what in slice_launches:
        r[k]['launches'] = slice_launches[what][k]
        r[k]['launches_per_control_step'] = r[k]['launches'] / slice_steps(
            what)
  for what, sub in core_sub.items():
    sub['launches'] = slice_launches[what]['chol_solve_batched']
    sub['core_calls'] = slice_core[what]['calls']
    sub['core_loops'] = slice_core[what]['loops']
    sub['launches_per_control_step'] = sub['launches'] / slice_steps(what)
  for what in k2_slice:
    sub = k2_sub[row_key(what)]
    sub['launches'] = slice_launches[what]['newton_solve_batched']
    sub['launches_per_control_step'] = sub['launches'] / slice_steps(what)
  for what, sub in ell_sub.items():
    if what in slice_launches:
      sub['launches'] = slice_launches[what]['newton_solve_ell']
      sub['launches_per_control_step'] = sub['launches'] / slice_steps(what)
  # the cone model's rows: the launches of its CONES_STEPS-step run (copies
  # 2 is held in phase kernels only)
  for k, r in slice_k1['cones x1'].items():
    r['launches'] = cone_launches[k]
  ell_sub['cones x1']['launches'] = cone_launches['newton_solve_ell']
  for r in [ell_sub['cones x1']] + list(slice_k1['cones x1'].values()):
    r['launches_per_physics_step'] = r['launches'] / CONES_STEPS

  # -- 7. train: gradients through the step, SAC on the card -----------------
  s_env = state = rewards = r_env = None
  torch.cuda.empty_cache()
  train_phase(lk, nk, rows, dev)

  # -- 8. composer: the locomotion tier through BatchedEnvironment ------------
  torch.cuda.empty_cache()
  composer_phase(lk, nk, rows, dev)

  # -- 9. manipulation: the Jaco tier through BatchedEnvironment --------------
  torch.cuda.empty_cache()
  manipulation_phase(lk, nk, rows, dev)

  log(f'# chip_smoke.py: {time.perf_counter() - t_start:.1f} s')
  log(smi)
  log(json.dumps({'kernels': rows}, allow_nan=False))
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
