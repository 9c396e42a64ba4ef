#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``nbody3d_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py                 # everything below, one card
    python3 chip_smoke.py --kernels-only  # build + small-shape checks (1-3, 7a, 8a-13a, 14a-17a)
    python3 chip_smoke.py --outdir DIR    # keep phase 7b's frames and checkpoints
    python3 chip_smoke.py --parent DIR    # also time a parent checkout's redesigned kernels

Phases, one line each (a failed check prints FAIL and the run exits 1):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: nvcc builds the nineteen kernels from ``nbody3d_tpu_torch/csrc``,
   one nvcc process per source, all started together; the registers and
   spill bytes (ptxas) of ``force_exact``, ``fused_step_exact``,
   ``sym_hops``, ``pair_sym``, ``vjp_sym_hops``,
   ``short_range``, ``short_range_bwd``, ``force_fast``,
   ``fused_step_fast``, ``sym_diag_prep``, ``sym_diag``, ``vjp_sym_diag``
   (both loops) and ``vjp_full`` and, where
   ``cuobjdump`` is on the machine, the
   count of their SASS instructions by opcode (``ATOMS``, ``RED``, ``LDS``,
   ``MUFU``, ``SHFL``, ``VOTE``, ``BSSY``, ``F2FP``, ``HMMA``, ...), in all
   and in the pair loop, a pair's by class (FP32, MUFU, LDS, F2FP, HMMA,
   VOTE, BSSY, BRA), the parent's too with ``--parent``; whether the
   machine has ``ncu``.
3. kernels: each kernel against its plain PyTorch twin on the card at
   N = 8,192 (nt even), 7,936 (nt odd) and 512 (nt = 2), padded rows
   included (forward: accelerations and the step; VJP: x̄, m̄ and Ḡ);
   ``force_exact`` and ``fused_step_exact`` at N = 8,192 with a 1e7 body
   at every S (source split) from 1 to 8 and at eps2 = 1e-4 and 1e-14 (the
   ftz and the guarded rsqrt), < 1e-5 of scale, the fused step bit-equal to
   ``force_exact`` + the torch Verlet, and ``force_exact`` on the ragged
   rectangular calls 1,999 x 8,192 and 8,192 x 1,999 (with ``--parent`` each
   bit-equal to the parent's kernel at the same S); ``sym_diag_prep``
   against its twin at tiles 256 (the template instance) and 128, 512,
   1,024, 40 and 96 (the runtime one; a partial last warp), a 1e7 body,
   eps2 = 1e-4 and 1e-14, with ``sym_diag`` on its source rows bit-equal to
   it (with ``--parent`` both outputs bit-equal to the parent's kernel);
   ``sym_hops`` (summed with the diagonal) against its twin, a 1e7 body
   and padded rows, at tile counts that cut a block's run of hops short
   (nt = 2, 8, 19, 35 and 36), at eps2 = 1e-14 (a subnormal eps2^3) and at
   tiles of 512 and 1024 rows: < 2e-5 of scale; ``vjp_sym_hops`` (summed
   with the diagonal) at the same tile counts and tiles, at eps2 = 1e-40
   (subnormal) and on ``pair_checks.vjp_heavy`` (a 1e7 body), < 2e-5 of
   scale, the parent's kernel too with ``--parent``; at those shapes and
   phase 3's ``vjp_sym_diag`` < 1e-5 of each column's scale and ``vjp_full``
   at every S from 1 to 8 (x̄, m̄ < 1e-5 of scale, Ḡ < 1e-5 of sum |A.F|;
   the twins in f64 at eps2 = 1e-40), with ``--parent`` ``vjp_sym_diag``'s
   ordered loop (tiles other than 256) and ``vjp_full`` at S = 1 bit-equal
   to the parent's kernels; the
   VJP accuracy gate of ``benchmarks/grad_bench.py`` (median x̄ relative
   error <= 1e-4 against an f64 numpy oracle, uniform-sphere N = 4,096,
   both schedules); then each kernel's time beside its twin's at the
   main-path shapes (exact: two-galaxy N = 40,002; sym and the VJPs:
   uniform-sphere N = 262,144, tile 256), ``sym_epilogue`` and
   ``vjp_combine`` with L2 warm and with L2 flushed, at full width the
   sym VJP against the full-grid VJP and both against f64 on 256 rows, and
   the VJP stages at the exact gradient path's shape and data (two-galaxy,
   nt = 157) against their twins, the full grid and f64; with
   ``--parent`` the parent's ``sym_diag_prep`` (bit for bit), ``sym_hops``,
   ``vjp_sym_hops``, ``vjp_sym_diag`` and ``vjp_full`` beside this tree's in
   turns (N = 262,144; the VJP kernels also at nt = 157), ``sym_diag_prep``'s
   guarded rsqrt beside its ftz one, and the three VJP pair kernels' guarded
   rsqrt beside their ftz one; ``vjp_full`` at every S at nt = 157; after
   phase 10's times, ``force_exact`` and ``fused_step_exact``, the launch
   alone, at two-galaxy n_pad 40,192 and N = 262,144: S, the guarded
   instance beside the ftz one in turns, ``force_exact`` at every S at
   40,192, and with ``--parent`` the parent's kernels in turns (bit-equal
   at the same S).
4. exact main path: ``Simulation.from_preset("two-galaxy", SimConfig())``
   (its Verlet steps, needing no gradient, run ``fused_step_exact``),
   200 steps in chunks of 50, energy drift <= 1e-3 and momentum error
   <= 1e-5 of sum |m v|.
5. sym main path: uniform-sphere N = 262,144, ``force_mode="sym"``,
   ``morton_every=64``; 1 warm and 2 timed chunks of 50 steps; energy
   drift <= 1e-4 * max(steps, 140) / 140, momentum error <= 1e-5.
6. gradients, ``torch.autograd`` through a rollout, forward and gradient
   ms/step: (a) the sym gradient path, ``make_step_fn`` at uniform-sphere
   N = 262,144 (5 steps, loss sum |x|^2 / n, gradient by v0, as
   grad_bench); (b) the exact gradient path at two-galaxy N = 40,002
   (3 steps; its forward needs no gradient and runs ``fused_step_exact``,
   its gradient ``force_exact`` + the torch Verlet); (c) the full-grid VJP route (``make_diff_accel(sym=False)``,
   on no main path) on (b)'s rollout, against (b)'s gradient; (d) at
   N = 4,096 the kernel routes' rollout gradient (sym, exact, exact with
   the full-grid VJP) against the ``backend="jnp"`` route's, rtol 2e-3,
   by v0 and by dt and G.
7. the render + checkpoint path: (a, after phase 3) ``splat_resolve``
   against its plain twin, bit for bit, on the scenes of
   tests/test_render.py, the two-galaxy frame and
   ``scatter_checks.resolve_adversarial``'s (4,096 splats on one pixel;
   r = 64 discs at the corners and off the frame); (b) the reference's
   default run through ``cli.main``: two-galaxy, 200 steps, a frame every
   50 and a checkpoint every 100, energy drift <= 1e-3 and momentum error
   <= 1e-5, then ``render`` of ``final.npz`` equal to the run's last frame
   and ``convert`` npz -> JSON -> npz bit-equal; (c, last) the kernel, its
   twin and ``scatter_reduce_`` over the expanded pairs (the library
   yardstick) at the run's frame and at N = 500,010 1920x1080
   (benchmarks/render_bench.py's scene), frame, PNG and checkpoint times.
8. the mesh solvers (``method="p3m"`` and ``"pm"``, isolated): (a, after
   7a) ``short_range``, ``mesh_deposit`` and ``mesh_gather`` against their
   plain twins on the clustered two-galaxy scene (n = 4,096) at N = 8,192
   and 7,936, tiles 128 and 256, grids 32 and 128, TSC and CIC, and
   ``short_range`` with slots masked (bit-equal to the parent's kernel with
   ``--parent``), and on ``pair_checks``' planted pairs (r^2 one ulp either
   side of rcut^2, a warp with one live lane, masked slots, coincident
   rows) against its twin and the parent's kernel; then ``mesh_deposit`` on
   ``scatter_checks.deposit_adversarial``'s isolated scenes (one cell,
   unsorted, Morton runs across octant boundaries), each against its twin
   as 8b's and its blocks a path equal to :func:`deposit_block_paths`'
   (the kernel's decisions emulated in torch), some blocks on each of the
   three paths; every ``mesh_gather`` check runs both its kernels (the
   runs' boxes for rows in Morton order, the loop alone for other rows),
   bit-equal to each other, their runs a path equal to
   ``gather_checks.block_paths``' mirror, and with ``--parent`` bit-equal
   to the parent's kernel, also on the isolated adversarial scenes at
   grids 16, 32 and 128; (b) the P3M path at full width,
   benchmarks/p3m_bench.py's configuration: two-galaxy N = 2,097,152,
   grid 128, k = 32, tile 256 (8,193 tiles: the two-level neighbour
   selection), 30 warm steps with the momentum error (<= 1e-5 of
   sum |m v|) over them, 2 timed chunks of 10, ms/step and the
   direct-equivalent G-int/s; then, on the state it leaves, the force of
   4,096 sampled bodies against ``force_exact`` (median < 2e-3,
   p99 < 1e-2) with the selection's tile overflow; ``short_range_bwd``
   against its twin under that two-level selection (its time, bounds and
   shares, and with ``--parent`` bit-equal to the parent's kernel and
   timed beside it in turns) and a 2-step rollout
   gradient's ms/step and peak memory; the three kernels at
   that shape beside their twins, bounds and (deposit) ``index_add_``
   (``short_range``'s bound counts the pairs within rcut, its all-pairs
   bound beside it, with the shares of its live-slot pairs within rcut and
   through the warps' votes and the slots that skip the votes counted on
   the card, and with ``--parent`` bit-equal to the parent's kernel and
   timed beside it in turns;
   the deposit per cell within the f32 summation bound, the total mass,
   and bit for bit on exact terms; its blocks a path; the gather's runs a
   path, and with ``--parent`` bit-equal to the parent's kernel and timed
   beside it in turns), and a force
   evaluation's device time stage by stage; (c) p3m_bench's accuracy probe (two-galaxy
   n = 16,384, grid 128) against ``force_exact``, median < 2e-3 and
   p99 < 1e-2, and ``cli run --method p3m`` on two-galaxy for 200 steps
   with the energy (<= 1e-3) and momentum (<= 1e-5) checks; (d) PM at
   two-galaxy N = 2,097,152, grid 128, 30 warm steps (momentum as 8b) and
   5 timed chunks of 50, then its CIC deposit and gather against their
   twins at that shape and data, as 8b's (the deposit beside
   ``index_add_``; the gather's loop alone, PM's rows being unsorted, with
   its runs and the parent's kernel as 8b's), and the gather beside
   ``grid_sample`` (its library call); (e) at N = 8,192 the kernel route
   of ``pm`` and ``p3m`` against ``backend="jnp"`` (accelerations and a
   5-step rollout, rtol 1e-4, atol 1e-5 of the scale).
9. the mesh gradients (``torch.autograd`` through ``method="p3m"`` and
   ``"pm"``): (a, after 8a) ``short_range_bwd`` against its plain twin on
   8a's scenes (N = 8,192 and 7,936, tiles 128 and 256) with a massless
   source tile and slots masked in mutual pairs: x̄ and m̄ rtol 1e-4, atol
   1e-5 of the scale, σ̄ rel 1e-3 (the JAX tests' gradient bounds), then
   on ``pair_checks``' planted scenes (with ``--parent`` each bit-equal to
   the parent's kernel); (b)
   the P3M gradient at benchmarks/grad_bench.py's configuration:
   uniform-sphere n = 2,097,152, grid 128, k = 32, tile 256 (8,192 tiles,
   the flat selection), a 5-step rollout, loss sum |x|^2 / n, gradient by
   v0, forward and gradient ms/step, their ratio and the peak memory, with
   every plain twin of the mesh path patched to raise; after the windows
   ``short_range_bwd`` at that shape beside its twin, both bounds, the
   shares and the slots without votes (with ``--parent`` also
   ``short_range_bwd`` and ``short_range`` bit-equal to the parent's
   kernels and timed beside them in turns); (c) the
   same for PM (grid 128, CIC); (d) at N = 8,192 (8e's scene) the kernel route's 5-step
   rollout gradient against ``backend="jnp"``'s for both methods, by v0,
   dt and G, rtol 2e-3.
10. the unfused sym step (``--integrator yoshida4|euler``,
   ``fuse_epilogue=False``, one tile) and the fused exact step
   (``fuse_integrate=True``): (a, after 9a) ``sym_diag``, ``sym_combine``
   and ``fused_step_exact`` against their twins at N = 8,192, 7,936, 512
   and 256 (nt = 1), padded rows included, ``fused_step_exact`` bit-equal
   to ``force_exact`` + the torch Verlet, ``accel_sym`` at both ``center``
   values against ``force_exact`` (< 2e-5); (b) phase 5's run with
   ``integrator="yoshida4"`` (3 force evaluations a step) and with
   ``fuse_epilogue=False``, 1 warm and 2 timed chunks of 20 steps each,
   phase 5's token, the unfused Verlet step beside phase 5's fused one;
   (c) one 20-step chunk of phase 4's simulation bit-equal to
   ``force_exact`` (S = 6) + the torch Verlet, with 20 ``fused_step_exact``
   launches and no ``force_exact``; phase 4's run through that composed
   step (a gradient's forward), phase 4's token, beside phase 4's; then
   profiled 3-step rollouts of the fused and the composed step; after
   the windows the three kernels' times at 10b's and 10c's shapes beside
   their twins, bounds and (``sym_combine``) ``torch.add``; (d) at N =
   4,096 6d's rollout gradient through the yoshida4 sym route against
   ``backend="jnp"``'s, rtol 2e-3, and a gradient request through
   ``fuse_integrate=True`` raises; (e) the uncentred route
   ``accel_sym(center=False)`` at N = 262,144 against ``center=True``.
11. fast mode (``force_mode="fast"``: bf16 weights on the tensor cores):
   (a, after 10a) ``force_fast`` and ``fused_step_fast`` against their
   twins at N = 8,192, 7,936, 512 and 256 (a 1e7 body, padded rows;
   max-abs/scale < 2e-4, the tensor cores' f32 sums against the twin's
   f64), ``force_fast`` on disjoint source sets (1,999 sources: ragged)
   and with the diagonal at offsets 1,000 (all rows, and a restricted row
   range) and -1,000, ``fused_step_fast``
   bit-equal to ``force_fast`` + the torch Verlet, all of these at eps2 =
   1e-4 and at 1e-14 (a subnormal eps2^3: the kernels' instance with
   ``rsqrtf`` and its guard), and ``force_fast``
   against an f64 numpy direct sum on the two-galaxy scene (2,048 rows
   with both centres) and on a near-coincident pair (N = 4,096): max-abs
   over scale <= 5e-3, a centre's own row <= 6e-3, the momentum rate
   printed; with ``--parent`` each ``force_fast`` and ``fused_step_fast``
   result bit-equal to the parent's kernel; (b) bench.py's fast configuration, uniform-sphere N =
   262,144, ``morton_every=64``, 1 warm and 2 timed chunks of 20 steps,
   phase 5's token; (c) phase 4's run with ``force_mode="fast"``
   (``fused_step_fast``) and then through ``force_fast`` + the torch Verlet,
   phase 4's token, each with a profiled 3-step rollout; after the windows both kernels' times beside their
   twins, their bounds and ``force_exact``/``fused_step_exact`` at the
   same shapes, and at 11b's (Morton order) ``fused_step_fast`` bit-equal
   to ``force_fast`` + the torch Verlet and against its twin, timed
   beside that composed route (with ``--parent`` bit-equal to the parent's kernels and
   timed beside them in turns, the launch alone, at 11b's and 11c's
   shapes, and ``force_fast`` with ``rsqrtf``'s guard, eps2 = 1e-14,
   beside the ftz instance); (d) at N = 4,096 6d's rollout gradient through the fast
   route against ``backend="jnp"``'s, by v0, dt and G, within 5e-3 of
   scale, and a gradient request through the fused fast step raises.
12. the periodic box (``boundary="periodic"``), forward: (a, after
   11a) the periodic forms of ``short_range``, ``mesh_deposit`` and
   ``mesh_gather`` against their twins on the unit box with bodies on the
   seams, N = 8,192 and 7,936, tiles 128 and 256, grids 32 and 128, TSC and
   CIC: the deposit per cell within its f32 summation bound, bit for bit
   on exact terms with the first and last cells written, the gather within
   1e-5 of the max, ``short_range`` rtol 2e-4, atol 3e-6 of the max against
   the twin and the twin in f64 (and the parent's kernel bit for bit with
   ``--parent``), and on ``pair_checks``' periodic planted pairs (8a's, and
   pairs across the seams); the periodic ``mesh_deposit`` on
   ``scatter_checks.deposit_adversarial``'s periodic scenes (one cell by the far
   corner, Morton runs across the seams and across octant boundaries), as
   8a's; the periodic ``mesh_gather`` as 8a's, also on
   ``gather_checks.seam_scenes()`` (a run across all three seams, the far
   corner with the padding rows, unsorted and uniform rows, a tight cluster
   about the corner) at grids 16, 32 and 128, and the tight and far corners
   at grid 1,290, the wrapper's largest (the second and third grids past
   2^31 floats), periodic and isolated; (b) p3m_bench's periodic configuration
   (uniform-box N = 2,097,152, box 10, grid 128, k = 32), plain and
   ``--interlace``, 30 warm steps with the momentum error (<= 1e-5 of
   sum |m v| after them) and 2 timed chunks of 10; after the windows the
   inherited ``nbr_k`` fault, reported and not gated (2,048 sampled bodies
   against the f64 Ewald oracle, the tile overflow, the quantiles of the
   tiles within rcut) and the three kernels at that shape beside their
   twins, bounds and (deposit) ``index_add_`` (``short_range`` as 8b's:
   both bounds, the shares and the parent's kernel; the gather as 8b's);
   (c) the
   accuracy gate:
   uniform-box N = 32,768, box 1, grid 32, k = 128 (overflow 0), interlace
   off and on, 2,048 sampled bodies against the f64 Ewald oracle, median <
   3e-3 and p99 < 2e-2; ``cli run --boundary periodic`` (the JAX collapse
   test: 200 steps, |dE|/KE < 1e-2, momentum < 1e-4 of sum |m v|); and at
   N = 8,192 the kernel route of periodic P3M and PM against
   ``backend="jnp"`` (8e's bounds); (d) periodic PM (CIC) at 12b's box, 30
   warm steps and 5 timed chunks of 50, then the net force < 3e-5 of
   sum |f| and its CIC kernels against their twins (the deposit and the
   gather as 8d's).
13. the periodic box's gradient: (a, after 12a) the periodic
   ``short_range_bwd`` against its twin (``_bwd_agrees``) on 12a's unit box
   with pairs planted across the seams at r = 1e-3, 1e-4 and 1e-5, N =
   8,192 and 7,936, tiles 128 and 256, grids 32 and 128, tile 3 massless
   and slots killed in mutual pairs, and on the planted pairs against the
   twin in f64 (1e-5 of the row plus 8 ulp of ``s⁻³ + k_long``, the
   forward's k with k_long's series below u = 0.5), and on
   ``pair_checks``' periodic planted scenes (a warp astride the k' switch
   at u = 0.2 among them; with ``--parent`` each bit-equal to the parent's
   kernel); ``deposit_vjp`` and ``gather_vjp`` with ``periodic=True``
   against autograd through their twins (1e-5 of the max), the gather's
   grid cotangent on exact terms bit for bit with the first and last cells
   written; (b) grad_bench's rollout (5 steps, by v0) through periodic P3M
   at p3m_bench's box (12b's), plain and ``--interlace``, every plain twin
   raising: forward and gradient ms/step, ratio, peak memory, the gradient
   finite and nonzero; after the windows the periodic ``short_range_bwd``
   at that shape beside its twin and both bounds (the pairs within rcut,
   all pairs) with the shares within rcut and through the votes (and the
   parent's kernel, bit for bit and in turns); (c) the same through periodic
   PM (CIC); (d) at N = 8,192 the kernel route's 5-step rollout gradient
   (by v0, dt, G) against ``backend="jnp"``'s for periodic P3M, interlaced
   P3M and PM, rtol 2e-3.
14. the macro-tiled sym schedule (``force_mode="sym"`` above
   ``MACRO_MIN_N`` = 786,432 bodies: ``accel_sym`` on each chunk,
   ``pair_sym`` on every unordered chunk pair): (a, after 13a)
   ``pair_sym`` against its twin at Nt x Ns = 8,192 x 7,936, 512 x 256 and
   256 x 256, tiles 128 and 256, padded rows and a 1e7 body (< 2e-5 of
   scale, the momentum printed), and ``accel_sym_macro`` at N = 8,192 with
   4 chunks against ``accel_sym``; ``pair_sym`` at source tile counts that
   cut a block's run short (ns = 2, 9 and 17 against nt = 3, 5 and 2, 1e7
   bodies on both sides, also at eps2 = 1e-14 and a tile of 1024, < 2e-5);
   (b) benchmarks/scale_sweep.py's top
   rung: uniform-sphere N = 2,097,152, sym, ``morton_every=64``, Verlet, 1
   warm and 5 timed 1-step chunks, ms/step, G-int/s, the momentum error
   (<= 1e-5 of sum |m v|) and each step's launches (4 ``sym_diag_prep``,
   4 x 2 ``sym_hops``, 4 ``sym_combine``, 6 ``pair_sym``); after the
   windows, on its state, the macro force and the direct ``accel_sym`` on
   2,048 sampled rows against f64 on the card (the macro no worse than 2x
   the direct + 1e-6 of scale), one call of each timed; (c) ``pair_sym``
   on a chunk pair (524,288 x 524,288) beside its FP32 bound, and against
   its twin at 131,072 x 131,072 (the twin's one run by host clock); (d) at
   N = 8,192 an explicit 4-chunk composition's 5-step rollout gradient
   against ``backend="jnp"``'s, by v0, dt and G, rtol 2e-3.
15. the cosmological workflow (``cosmology="eds"|"lcdm"``: the comoving
   kick-drift of ``ops/expansion.py`` on the periodic mesh force; the
   ``cosmo`` preset; ``analysis.py``): (a, after 14a) a Zel'dovich box of
   32^3 bodies (box 10, grid 32, k = 128, no tile overflow): for EdS and
   ΛCDM (Ω_Λ = 0.7) × PM and P3M, 5 comoving steps by the kernel route
   against ``backend="jnp"`` (positions and momenta rtol 1e-4, atol 1e-5 of
   the max); tests/test_expansion.py's EdS growth gate on the kernels (P3M,
   amp 0.02, a = 1 to 2.25 in 70 steps, the low-k band power within 8% of
   a², the comoving momentum < 1e-4 of Σ|m·w|); ``power_spectrum`` by the
   kernel route against its twin (mode counts bit-equal, P rtol 1e-4) at
   grids 32 and 64; the streamed FoF against the direct one
   (tests/test_analysis.py's scene and bounds); (b) the ``cosmo`` preset at
   128^3 = 2,097,152 bodies in 12b's box (grid 128, k = 32, dt = t_i/100):
   EdS P3M, 30 warm steps (the momentum gate) and 2 timed chunks of 10, its
   ms/step beside 12b's; ΛCDM P3M one timed chunk of 10; EdS PM 5 timed
   chunks of 50 beside 12d's; each with a profiled step and the device
   launches a step against the plain periodic step on the same state, by
   kernel; after the windows the inherited ``nbr_k`` fault at the EdS state,
   reported as 12b's and not gated; (c) the analysis of the EdS end state
   on the card, each timed on the host clock ending in a synchronize:
   ``summary`` (its device-to-host copies counted by the profiler: 1),
   ``power_spectrum`` at grid 128 (one ``mesh_deposit``, against its twin),
   the direct and the streamed FoF (streamed within 1e-3 of N of the direct
   one's linked bodies) and ``group_catalog``.
16. the live viewer and the rest of render: (a, after 15a, also in
   ``--kernels-only``) the quantized ``resolve="device"`` (``scatter_reduce_``
   on the card for the splats below 2 px, the rest stamped on the host) on
   the scenes of tests/test_render.py:206-246 and the two-galaxy frame:
   the card's framebuffer bit-equal to the CPU route's on a copy of the
   same prep, and against the exact ``auto`` frame lit pixels agree on
   > 0.999 and rgb within 8 on > 0.995 (one body: its pixel; the
   two-galaxy frame's rgb share printed, not gated: 16-bit depth ties in
   a galaxy's narrow depth range, where the JAX package's own device
   resolve has the same share, tests/test_torch_viewer.py); at N =
   500,010 1920x1080 the device-resolve frame beside the ``auto`` frame
   (in turns) and the bytes each copies to the host; (b) ``LiveViewer`` on
   the reference default (two-galaxy N = 40,002, exact, 960x720, 20 steps a
   frame) on an ephemeral port, every HTTP call with a timeout: /frame.jpg
   and 3 /stream parts (SOI/EOI), pause after ten pipelined frames (steps
   = 20 a frame, energy drift <= 1e-3 over them), the paused /frame.jpg
   equal to ``encode_jpeg(render_frame(same camera))`` byte for byte,
   /control orbit, pan, zoom, logdt, size=640x480 and reset, /export.npz
   then POST /import.npz while paused (bit-equal; the file holds the
   paused dt, 0), the imported sim set running by /control?logdt (2 s of
   frames: steps = 20 a frame), regenerate; the HUD's fps, frame, compute, host, render and
   encode ms and the JPEG bytes; with the loop stopped the frame interval
   beside the sequential sum chunk + render + encode (printed, not gated)
   and one profiled pipelined frame (idle share); (c) ``cli animate`` of
   7b's ``final.npz``, 12 frames as APNG (``acTL`` 12, each frame equal to
   its PNG) and GIF (12 images); (d) ``cli run --trace`` writes a trace
   that names ``force_exact``.
17. sharded direct stepping (``parallel/``; the machine has one card, and
   NCCL takes one rank a card): (a, after 16a, also in ``--kernels-only``)
   the D-rank schedules replayed rank by rank in one process, the step's
   own hop functions (``sharded.hop_force``, ``SymHops``) on the shapes and
   diagonals of a D-rank run with slices in place of the collectives, each
   rank's assembled force against the single-device kernel at full width:
   exact two-galaxy N = 40,002, ring and gather at D = 2, 4, 8 and the 2 x 2
   grid, exact (< 1e-5 of scale) and fast (< 2e-4); sym uniform-sphere N =
   262,144, ringsym at D = 2, 4, 8 and at D = 2 with 2 source chunks a pair
   hop (< 2e-5); (b) phase 4's run through ``Simulation(mesh=
   default_mesh(1))`` over NCCL (a process group of one rank), strategy
   ring, phase 4's token, ms/step beside phase 4's; (c) phase 5's run with
   strategy ring and ``force_mode="sym"`` (ringsym at one rank: the sym
   chain and the torch Verlet), phase 5's token, ms/step beside phase 5's;
   (d) the gather and the 1 x 1 grid (two-galaxy, one chunk of 50 each)
   bit-equal to one device's run from the same state, and the sharded
   diagnostics against the single-device ones (rtol 1e-5).
18. sharded PM and P3M (``parallel/exchange.py``, ``parallel/mesh_force.py``):
   (a, after the small-shape checks, not in ``--kernels-only``) the sharded
   P3M force replayed rank by rank in one process on the kernel route
   (``ReplayGroup``: the collectives as sums and concatenations over a
   list), at 12b's box with D = 2, 4, 8 and at 8b's two-galaxy scene
   (padded for 8 ranks to 8,200 tiles) with D = 8, stage by stage: (i) the
   concatenated sorted slices are the global stable (key, gid) sort and the
   inverse exchange restores every row, bit for bit; (ii) each rank's
   ``short_range`` over [slice ; halo] (its first 128 target tiles) within
   the P3M tests' bound of its twin, its ``mesh_deposit`` within the f32
   summation bounds (``_deposit_agrees``) and its sorted-rows
   ``mesh_gather`` within 1e-5 of the twin; each rank's halo demand
   against ``h_cap``; (iii) at 12b, where the tiles and the selection are
   one device's, the assembled force against the single-device P3M within
   rtol 1e-4, atol 1e-5 of the max (a truncated halo: (iv) instead); (iv)
   at 8b the net kick <= 1e-5 of sum |m a|; (b) 12b's periodic P3M and
   12d's periodic PM, (c) 15b's comoving EdS P3M and (d) 8b's isolated P3M
   through ``Simulation(mesh=default_mesh(1))`` (NCCL, one rank), 30 warm
   steps and 2 timed chunks of 10, ms/step beside the one-device phase in
   the same call, then one step from the end state against one device's
   step within rtol 1e-4, atol 1e-5 of the max (not bit for bit: the
   deposit's atomics).  Phase 18's lines carry the card's name and power
   limit.
19. the sharded render (``render/sharded.py``): (a, after 18a, not in
   ``--kernels-only``) D = 2, 4 and 8 ranks replayed in one process
   (``ReplayGroup``), each rank's prep and ``splat_resolve`` on its shard
   of the state padded as a D-rank engine pads it (the padding in the last
   shard), one ``amin`` of the flipped words, bit-equal to one launch on the
   real rows, at two-galaxy N = 40,002 960x720 and N = 500,010 1920x1080;
   at 1080p, D = 8, a rank's frame, the replayed merge and one device's
   frame by CUDA events; (b) ``Simulation(mesh=default_mesh(1))`` (NCCL,
   one rank) after a Morton re-sort and after a sharded P3M step:
   ``render_frame`` with ``auto``, ``host`` and ``device`` and each one's
   begin/finish around a chunk, the padding at the tail, no host sync in
   the ``auto`` begin (``set_sync_debug_mode("warn")``), its window the
   mesh's calls alone; after the window each frame bit-equal to one
   device's frame of the same rows, and the sharded frame's time beside one
   device's; (c) 16b's serve loop on the one-rank mesh (its op records over
   the gloo side group), its frame interval beside 16b's from the same
   call, then the viewer's pipelined frame on the mesh and on one device in
   turns; (d) ``dryrun_multichip(1, "cuda")`` in a spawned NCCL rank, the
   kernels it launched.  Phase 19's lines carry the card's name and power
   limit.
20. the host C modules (``nbody3d_tpu_torch/native/``, built with ``cc`` at
   first use; after 19d, not in ``--kernels-only``; no CUDA kernel of
   their own): (a) 16a's quantized frame (N = 500,010, 1920x1080) with its
   large splats stamped by ``_raster.c`` bit-equal to the ``_stamp_large``
   twin's on the same words and splats, the large-splat count, the frame
   time with either stamp (host clock, median of 3, in turns); the ``host``
   frame (``_raster.c`` over every splat) at 7c's N = 500,010 1920x1080 and
   serve's two-galaxy N = 40,002 960x720 bit-equal to ``resolve_keys_plain``,
   with both times; (b) 8d's PM state (N = 2,097,152) saved and loaded
   through ``_fastjson.c``: the round trip bit-equal (arrays, the "G"
   string, dt, step, camera), ``json.loads`` of the file giving the same
   float32 arrays, save and load seconds and the file's MB, beside the
   ``json.dump`` writer at N = 500,000.  Its lines carry the card's name
   and power limit; every time in it is the card machine's host's.
21. the last pieces of the JAX package (after 20b, not in
   ``--kernels-only``; plain torch, no kernel of their own): (a) 8d's PM
   state (N = 2,097,152) saved as a checkpoint directory
   (``torch.distributed.checkpoint``) and loaded back to the card: the
   round trip bit for bit (uint32 views), dt, G, step and the camera;
   save and load seconds and MB beside the ``.npz`` save and load of the
   same state, in turns; ``peek_config``'s time; then, under a one-rank
   NCCL group, the same state saved and loaded on ``default_mesh(1)``,
   each call in a thread that must return within 120 s (no collective
   waits on a peer), the directory's tensors and the loaded arrays
   bit-equal to the one-device directory's; (b) the Ewald energy
   ``ewald_potential_energy`` on the card: float32 at 15a's Zel'dovich
   lattice scaled to 32^3 = 32,768 bodies in 12b's box (L = 10) within
   ``ewald.energy_f32_bound`` of the float64 energy on the card, itself
   held at a 4,096-body subset to the host's ``ewald_potential_energy_f64``
   (rel 1e-12), both times; at N = 256 in float64, autograd's gradient
   against ``-m a`` of ``ewald_accel_reference`` (atol 1e-9 of scale,
   rtol 1e-7, as the CPU test).  Its lines carry the card's name and
   power limit.

Phases 4, 5, 6a, 6b, 7b, 8b, 8d, 9b, 9c, 10b, 10c, 11b, 11c, 12b (twice),
12d, 13b (twice), 13c, 14b, 15b (three times), 16b, 17b-17d, 18b-18d, 19b and 19c (the main paths)
and 6c, 6d, 8c, 8e, 9d, 10d, 10e, 11d, 12c, 13d, 14d, 15c, 16c, 16d and 19d each
run with the launch counts set to 0
just before and read just after; each must launch every kernel it runs and no other, and
the SM clock, power draw and temperature are printed after each.  One
profiled rollout of 6a and 6b each, one profiled frame of 7b, one profiled
step of 8b, 8d, 10b (yoshida4), 12b (each), 12d, 14b and 15b (each), one pipelined frame of 16b and 19c and one profiled gradient rollout of 9b, 9c,
13b (each) and 13c (device busy time, idle share, largest kernels; for the
gradients the share of each stage; 6a's ``vjp_combine`` and 10b's
``sym_combine`` device time a launch, their inputs as their paths leave
them) follow their windows.  The line before the last is ``{"kernels":
[...]}`` (launches summed over the main paths, ``vjp_full``'s from 6c
and ``sym_diag``'s from 10e; ``short_range``, ``mesh_deposit``,
``mesh_gather`` and ``short_range_bwd`` carry a ``periodic`` entry with
12b's, 12d's, 13b's, 13c's, 15b's, 18b's and 18c's launches and the periodic form's numbers at
12b's shape (``short_range_bwd``: 13b's);
``bound_ms`` from this run's shapes and the operation counts in each
kernel's source note); the last is the ``{"ok": true, "device": ...}``
line.  Without a CUDA card it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import http.client
import io
import itertools
import json
import pathlib
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from nbody3d_tpu_torch import SimConfig, Simulation, _build, analysis, cli, gather_checks, pair_checks
from nbody3d_tpu_torch.models.registry import make_preset
from nbody3d_tpu_torch.ops import cuda_force as cf
from nbody3d_tpu_torch.ops import ewald
from nbody3d_tpu_torch.ops import force_vjp as fv
from nbody3d_tpu_torch.ops import mesh_cuda as mc
from nbody3d_tpu_torch.ops import p3m, pm
from nbody3d_tpu_torch.ops.integrate import apply_integrator, integrate_state, valid_mask
from nbody3d_tpu_torch.ops.launch import (
    EXACT_MAX_SPLIT, KERNELS, exact_split, hop_blocks, launch, launch_counts, reset_launch_counts, sm_count,
    split_hops, sym_runs,
)
from nbody3d_tpu_torch.ops.morton import morton_reorder
from nbody3d_tpu_torch.ops.step import (
    GPU_TILE, PAD_GRANULE, fit_block, macro_chunks, make_step_fn, make_sym_accel_fn, run_chunk,
)
from nbody3d_tpu_torch.parallel import exchange, sharded
from nbody3d_tpu_torch.parallel.exchange import ReplayGroup
from nbody3d_tpu_torch.parallel.mesh import default_mesh, grid_mesh
from nbody3d_tpu_torch.parallel.mesh_force import ShardedP3M, ShardedPM
from nbody3d_tpu_torch.render import rasterize, resolve
from nbody3d_tpu_torch.render.image import read_apng, read_png, save_png
from nbody3d_tpu_torch.scatter_checks import (
    deposit_adversarial, deposit_operands, f32_sum_bounds, f32_sum_excess, resolve_adversarial,
)
from nbody3d_tpu_torch.state import SimState, init_state, pad_count
from nbody3d_tpu_torch.utils.camera import Camera

G, EPS2, DT = 1e-4, 1e-4, 1e-3
FLT_MIN = float(np.finfo(np.float32).tiny)  # the least normal f32: the VJP kernels' ftz rsqrt needs eps2 >= it
DT_MAIN = SimConfig().dt  # the main path's step, as grad_bench uses
SRC = "nbody3d_tpu_torch/csrc/"
PALLAS = "nbody3d_tpu/ops/pallas_force.py:"
VJP = "nbody3d_tpu/ops/force_vjp.py:"
REPLACES = {
    "force_exact": (SRC + "force_exact.cu", PALLAS + "263"),
    "sym_diag_prep": (SRC + "sym_diag_prep.cu", PALLAS + "770"),
    "sym_hops": (SRC + "sym_hops.cu", PALLAS + "582"),
    "sym_epilogue": (SRC + "sym_epilogue.cu", PALLAS + "1122"),
    "sym_diag": (SRC + "sym_diag.cu", PALLAS + "545"),
    "sym_combine": (SRC + "sym_combine.cu", PALLAS + "977"),
    "fused_step_exact": (SRC + "fused_exact.cu", PALLAS + "217"),
    # _force_kernel_fast_nomask (the main path's), _fast_diag and _fast.
    "force_fast": (SRC + "force_fast.cu", PALLAS + "293", PALLAS + "320", PALLAS + "270"),
    "fused_step_fast": (SRC + "fused_fast.cu", PALLAS + "239"),
    "vjp_full": (SRC + "vjp_full.cu", VJP + "205"),
    "vjp_sym_diag": (SRC + "vjp_sym_diag.cu", VJP + "434"),
    "vjp_sym_hops": (SRC + "vjp_sym_hops.cu", VJP + "450"),
    "vjp_combine": (SRC + "vjp_combine.cu", VJP + "490"),
    "splat_resolve": (SRC + "splat_resolve.cu", "nbody3d_tpu/render/pallas_resolve.py:105"),
    "short_range": (SRC + "short_range.cu", "nbody3d_tpu/ops/p3m.py:709"),
    "short_range_bwd": (SRC + "short_range_bwd.cu", "nbody3d_tpu/ops/p3m.py:885"),
    "mesh_deposit": (SRC + "mesh_deposit.cu", "nbody3d_tpu/ops/mesh_pallas.py:215"),
    "mesh_gather": (SRC + "mesh_gather.cu", "nbody3d_tpu/ops/mesh_pallas.py:285"),
    "pair_sym": (SRC + "pair_sym.cu", PALLAS + "1355"),
}

# Least time for a kernel's work (PERF.md "bound"): the larger of its FP32
# operations over the FP32 rate, its rsqrt count over the MUFU rate and its
# bytes (each input read once, each output written once) over HBM.  Rates
# of an H100 SXM at its 1.98 GHz boost clock: 132 SMs x 128 FP32 lanes x 2
# (an FMA is 2 FLOP) = 66.9 TFLOP/s (the published 67), 132 x 16 MUFU
# results a clock, 3.35 TB/s HBM3.  FP32 FLOP per pair (or per row for the
# O(N) kernels) are counted from each kernel's inner loop in csrc/ (source
# notes there); each pair kernel does one rsqrt a pair.
FP32_FLOPS = 132 * 128 * 2 * 1.98e9
MUFU_RATE = 132 * 16 * 1.98e9
HBM_BYTES = 3.35e12
FLOP = {
    "force_exact": 18, "sym_diag_prep": 18, "sym_hops": 25, "sym_epilogue": 33,
    "sym_diag": 18, "sym_combine": 3, "fused_step_exact": 18,
    # fast: 3 subtractions, 3 FMA (d2) and 2 multiplies (d2^3) a pair on the
    # FP32 pipe; the 32 bf16 FLOP a pair on the tensor cores are ~1/7 of
    # the MUFU time, which binds.
    "force_fast": 11, "fused_step_fast": 11,
    "vjp_full": 53, "vjp_sym_diag": 53, "vjp_sym_hops": 61, "vjp_combine": 8,
    # short_range and short_range_bwd a pair; mesh_deposit and mesh_gather a particle (TSC).
    "short_range": 47, "short_range_bwd": 100, "mesh_deposit": 82, "mesh_gather": 216,
}
# MUFU results a short_range (and short_range_bwd) pair: two rsqrt, the ex2 of
# expf, the rcp of 1/(1 + p u).
SR_MUFU = 4

FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def bound(name: str, units: float, nbytes: float, rsqrts: float = 0.0) -> dict:
    """``bound_ms`` and ``bound_by`` of ``units`` pairs (rows for the O(N)
    kernels) of kernel ``name`` moving ``nbytes``."""
    ops_s = max(units * FLOP[name] / FP32_FLOPS, rsqrts / MUFU_RATE)
    bytes_s = nbytes / HBM_BYTES
    return {"bound_ms": max(ops_s, bytes_s) * 1e3, "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def hop_pairs(n: int, b: int) -> int:
    nt = n // b
    return nt * (nt - 1) // 2 * b * b


def _queue_ahead(reps: int) -> None:
    """Hold the stream in a spin kernel while the host enqueues ``reps``
    launches, so that the events time the device and not the host's
    launch rate (a wrapper call costs some 20-40 us of Python)."""
    torch.cuda._sleep(max(20_000_000, reps * 400_000))  # cycles, ~10 ms at 1.98 GHz


def cuda_ms_cold(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn()`` in ms with the L2 flushed before each
    launch (``flush``, larger than the L2, is written in full outside the
    timed events; its dirty lines are in L2 when ``fn`` starts)."""
    fn()
    torch.cuda.synchronize()
    _queue_ahead(reps)
    events = []
    for _ in range(reps):
        flush.fill_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def host_ms(fn) -> float:
    """One call of ``fn()`` on the host clock, synchronised, in ms."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``
    back-to-back launches (L2 warm: the launches reuse one set of tensors)."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    _queue_ahead(reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ phases
def nvidia_smi(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields>`` of card 0, one CSV line."""
    return subprocess.run(
        ["nvidia-smi", "--id=0", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def print_clocks(after: str) -> None:
    print(f"  clocks after {after}: {nvidia_smi('clocks.sm,power.draw,temperature.gpu')} "
          "(SM MHz, W, C)", flush=True)


CARD: dict[str, str] = {}  # nvidia-smi's "name, power.limit", printed beside phase 18's numbers


def phase_device() -> torch.device:
    smi = CARD["smi"] = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(
        f"[1 device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"python {sys.version.split()[0]} | count {torch.cuda.device_count()}",
        flush=True,
    )
    return torch.device("cuda", 0)


def phase_build() -> None:
    t0 = time.perf_counter()
    path, nvcc_s = _build.build()
    _build.load_library()
    print(
        f"[2 build] {len(_build.SIGNATURES)} kernels ({len(KERNELS)} counted), nvcc {nvcc_s:.1f} s, build+load {time.perf_counter() - t0:.1f} s -> "
        f"{path.relative_to(_build.BUILD_ROOT.parent.parent)}",
        flush=True,
    )
    for line in _build.build_log().splitlines():
        if "Used" in line or "Function properties" in line:
            print(f"  ptxas: {line.strip()}")
    sym_kernel_report("this tree", _build.build_log(), path)
    print(f"  ncu (Nsight Compute): {ncu_path() or 'not on PATH, none under /usr/local/cuda/bin'}", flush=True)


# The pair kernels whose inner loop PERF.md describes from these counts.
SYM_PAIR_KERNELS = ("force_exact_kernel", "fused_step_exact_kernel", "sym_hops_kernel", "pair_sym_kernel",
                    "vjp_sym_hops_kernel", "short_range_kernel", "short_range_bwd_kernel", "force_fast_kernel",
                    "fused_step_fast_kernel", "sym_diag_prep_kernel", "sym_diag_kernel", "vjp_sym_diag_kernel",
                    "vjp_sym_diag_n3_kernel", "vjp_full_kernel")
SASS_OPS = ("ATOMS", "ATOM", "RED", "LDS", "STS", "SHFL", "VOTE", "BSSY", "MUFU", "FFMA", "FMUL", "FADD", "FSEL",
            "BAR", "F2FP", "HMMA", "BRA")
# The FP32 pipe's opcodes, summed as one class in the pair loops' counts.
FP32_OPS = ("FADD", "FMUL", "FFMA", "FSEL", "FSETP", "FMNMX", "FSET")
# A pair's rsqrts (MUFU.RSQ): how a loop's instructions become a pair's, for
# the kernels that do not issue one MUFU a pair.  short_range counts all of
# its MUFUs (SR_MUFU); short_range_bwd's branches hold other MUFUs (erff,
# erfcf, the division) that a pair may not reach, but every pair that takes
# the arithmetic takes its two rsqrts.
PAIR_RSQ = {"short_range_bwd_kernel": 2}


def ptxas_usage(log: str) -> dict[str, dict]:
    """Registers and spill bytes of each entry function in an ``nvcc
    -Xptxas -v`` log, by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


def sass_listing(lib_path) -> dict[str, list[tuple[int, str, int | None, str]]]:
    """Each function's SASS in the library (``cuobjdump -sass``), by mangled
    name, as ``(address, opcode, branch target, opcode with its
    modifiers)``; {} where there is no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return {}
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, timeout=120).stdout
    out, name = {}, None
    for line in text.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = m.group(1)
            out[name] = []
        elif name and (m := re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)(.*)",
                                      line)):
            target = re.search(r"0x([0-9a-f]+)", m.group(4)) if m.group(2) == "BRA" else None
            out[name].append((int(m.group(1), 16), m.group(2), int(target.group(1), 16) if target else None,
                              m.group(2) + m.group(3)))
    return out


def _op_counts(listing) -> dict[str, int]:
    counts: dict[str, int] = {}
    for _, op, _, _ in listing:
        counts[op] = counts.get(op, 0) + 1
    return counts


def pair_loops(listing) -> list[list]:
    """The instructions of each pair loop: of the loops (a backward branch
    and its target) that hold MUFUs (one a pair) and no other such loop,
    those that hold the most; [] if there is none.  ``short_range``'s
    isolated form has two, the sweep with the votes and the one without."""
    mufu = [a for a, op, _, _ in listing if op == "MUFU"]
    loops = {(t, a) for a, op, t, _ in listing if op == "BRA" and t is not None and t < a}
    held = {span: sum(span[0] <= m <= span[1] for m in mufu) for span in loops}
    held = {s: n for s, n in held.items() if n}
    inner = {s: n for s, n in held.items() if not any(o != s and s[0] <= o[0] and o[1] <= s[1] for o in held)}
    if not inner:
        return []
    top = sorted(s for s, n in inner.items() if n == max(inner.values()))
    return [[x for x in listing if lo <= x[0] <= hi] for lo, hi in top]


def loop_pairs(kernel: str, loop) -> float:
    """Pairs a lane in one pass of a pair loop (see PAIR_RSQ)."""
    if kernel in PAIR_RSQ:
        return sum(full == "MUFU.RSQ" for _, _, _, full in loop) / PAIR_RSQ[kernel]
    return sum(op == "MUFU" for _, op, _, _ in loop) / (SR_MUFU if kernel == "short_range_kernel" else 1)


def ncu_path() -> str | None:
    """Nsight Compute's command line where the machine has it."""
    import shutil

    tool = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    return tool if pathlib.Path(tool).exists() else None


def sym_kernel_report(tag: str, log: str, lib_path) -> None:
    """Registers and spills (ptxas) of the pair kernels, their SASS
    instructions by opcode, and those of the pair loop (each instance; the
    Newton-3 kernels and fast mode issue one MUFU a pair, so the loop's
    counts over its MUFUs are a pair's; ``short_range`` four, SR_MUFU, on a
    pair that takes the arithmetic, so its counts are a pair's when the vote
    is live, and a pair whose vote is not skips the arithmetic's branch;
    ``short_range_bwd`` two rsqrts, PAIR_RSQ, and the counts are static: a
    branch's instructions count whether a pair takes it or not).  The
    classes: FP32 (FP32_OPS), MUFU, LDS, F2FP, HMMA, VOTE, BSSY, BRA."""
    usage, sass = ptxas_usage(log), sass_listing(lib_path)
    for kernel in SYM_PAIR_KERNELS:
        for name in sorted(n for n in set(usage) | set(sass) if re.search(rf"\d{kernel}", n)):
            listing = sass.get(name, [])
            if not listing:
                print(f"  [{tag}] {name}: {usage.get(name, {})}; no cuobjdump", flush=True)
                continue
            ops = _op_counts(listing)
            print(f"  [{tag}] {name}: {usage.get(name, {})}; SASS {len(listing)} instructions: "
                  + ", ".join(f"{op} {ops.get(op, 0)}" for op in SASS_OPS), flush=True)
            for raw in pair_loops(listing):
                loop, pairs = _op_counts(raw), loop_pairs(kernel, raw)
                n = sum(loop.values())
                classes = {"FP32": sum(loop.get(op, 0) for op in FP32_OPS),
                           **{op: loop.get(op, 0) for op in ("MUFU", "LDS", "F2FP", "HMMA", "VOTE", "BSSY", "BRA")}}
                classes["other"] = n - sum(classes.values())
                print(f"    pair loop: {n} instructions for {pairs:g} pairs a lane "
                      f"({n / max(pairs, 1):.2f} a pair; by class a pair: "
                      + ", ".join(f"{c} {v / max(pairs, 1):.3f}" for c, v in classes.items()) + "): "
                      + ", ".join(f"{op} {c}" for op, c in sorted(loop.items(), key=lambda kv: -kv[1])), flush=True)


def _inputs(rng, n_pad: int, n_real: int, dev):
    pm = np.concatenate(
        [rng.normal(scale=2.0, size=(n_pad, 3)), rng.uniform(10, 50, (n_pad, 1))], axis=1
    ).astype(np.float32)
    pm[n_real:] = 0.0
    vel = np.concatenate([rng.normal(size=(n_pad, 3)) * 0.1, np.zeros((n_pad, 1))], axis=1)
    aold = np.concatenate([rng.normal(size=(n_pad, 3)), np.zeros((n_pad, 1))], axis=1)
    vel[n_real:] = 0.0
    aold[n_real:] = 0.0
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (pm, vel, aold))


def phase_kernel_checks(dev) -> None:
    """Kernels vs their plain twins on the same inputs, all rows."""
    print("[3 kernels] kernel vs plain twin, small shapes", flush=True)
    rng = np.random.default_rng(0)
    for n_pad, b, n_real in [(8192, 256, 8000), (7936, 256, 7900), (512, 256, 500)]:
        nt = n_pad // b
        pm, vel, aold = _inputs(rng, n_pad, n_real, dev)
        ex = cf.force_exact(pm, pm, G, EPS2)
        ex_p = cf.force_exact_plain(pm, pm, G, EPS2)
        torch.cuda.synchronize()
        check(rel_err(ex, ex_p) < 1e-5,
              f"N={n_pad} nt={nt}: force_exact vs plain max-abs/scale {rel_err(ex, ex_p):.3e} < 1e-5")

        p1, v1, a1 = pm.clone(), vel.clone(), aold.clone()
        cf.sym_step_(p1, v1, a1, DT, G, eps2=EPS2, b=b, n_real=n_real)
        torch.cuda.synchronize()
        p0, v0, a0 = pm.clone(), vel.clone(), aold.clone()
        src, acc_d = cf.sym_diag_prep_plain(p0, G, EPS2, b)
        acc_h = cf.sym_hops_plain(src, EPS2, b)
        cf.sym_epilogue_plain_(acc_d, acc_h, p0, v0, a0, DT, n_real)
        torch.cuda.synchronize()
        ea, ep, ev = rel_err(a1, a0), max_abs(p1, p0), max_abs(v1, v0)
        check(ea < 5e-5 and ep <= 1e-6 and ev <= 1e-6,
              f"N={n_pad} nt={nt}: sym step vs plain stages accel {ea:.3e} < 5e-5, "
              f"|dp| {ep:.3e} <= 1e-6, |dv| {ev:.3e} <= 1e-6")
        frozen = (torch.equal(p1[n_real:], pm[n_real:]) and torch.equal(v1[n_real:], vel[n_real:])
                  and bool((a1[n_real:] == 0).all()))
        check(frozen, f"N={n_pad} nt={nt}: padded rows frozen, stored accel zero")
        es = rel_err(a1[:n_real], ex[:n_real])
        check(es < 2e-5, f"N={n_pad} nt={nt}: sym accel vs exact accel {es:.3e} < 2e-5")
        torch.cuda.synchronize()
    phase_exact_checks(dev)
    phase_sym_run_checks(dev)
    phase_sym_diag_checks(dev)


# (N, tile) of sym_diag_prep's checks: the template width 256, the runtime
# instance at 128, 512 and 1024, and at 40 and 96 (a partial last warp).
SYM_DIAG_SHAPES = ((8192, 256), (7936, 256), (512, 256), (4096, 128), (4608, 512), (8192, 1024), (4000, 40),
                   (960, 96))


def phase_sym_diag_checks(dev) -> None:
    """``sym_diag_prep`` (``csrc/pair.cuh``'s in-tile loop) against its twin
    at SYM_DIAG_SHAPES with a 1e7 body and padded rows, at eps2 1e-4 (the
    ftz rsqrt) and 1e-14 (``rsqrtf`` with its guard): < 1e-5 of scale, the
    source rows equal, w lane 0; ``sym_diag`` on its source rows bit-equal
    to it; with ``--parent`` both outputs bit-equal to the parent's
    kernel."""
    rng = np.random.default_rng(17)
    for n, b in SYM_DIAG_SHAPES:
        pm = _inputs(rng, n, n - 24, dev)[0]
        pm[n // 3, 3] = 1e7
        for eps2 in (EPS2, 1e-14):
            tag = f"N={n} tile {b} eps2 {eps2:g}"
            src, acc = cf.sym_diag_prep(pm, G, eps2, b)
            src_p, acc_p = cf.sym_diag_prep_plain(pm, G, eps2, b)
            same = torch.equal(cf.sym_diag(src, eps2, b), acc)
            e = rel_err(acc, acc_p)
            check(torch.equal(src, src_p) and e < 1e-5 and not acc[:, 3].any() and same,
                  f"{tag}: sym_diag_prep vs plain with a 1e7 body {e:.3e} < 1e-5, the source rows equal, w lane 0; "
                  f"sym_diag on its source rows bit-equal to it")
            _parent_equal(f"{tag}: sym_diag_prep", (src, acc), parent_sym_diag_prep, pm, G, eps2, b)


# force_exact's ragged rectangular calls (n_t, n_s): neither count a multiple
# of the 128-source tile or of S tiles (exact_split gives S = 8 for both).
EXACT_RAGGED = ((1999, 8192), (8192, 1999))
# The softenings of the exact kernels' checks: the default, whose cube is a
# normal float (the ftz rsqrt), and 1e-14, whose cube is subnormal (rsqrtf
# with its guard).
EXACT_EPS2 = (EPS2, 1e-14)


def force_exact_split(tgt, src, g: float, eps2: float, split: int, out=None) -> torch.Tensor:
    """``force_exact``'s launch alone with ``split`` CTAs a block of rows
    (the wrapper passes ``exact_split``'s)."""
    out = torch.empty_like(tgt) if out is None else out
    launch("force_exact", tgt.device, _build.load_library().nb_force_exact, tgt, src, out, tgt.shape[0],
           src.shape[0], float(g), float(eps2), split)
    return out


def fused_exact_split(pm, vel, aold, dt: float, g: float, eps2: float, n_real: int, split: int, out=None):
    """``fused_step_exact``'s launch alone with ``split`` CTAs a block of rows."""
    n = pm.shape[0]
    out = tuple(torch.empty_like(pm) for _ in range(3)) if out is None else out
    launch("fused_step_exact", pm.device, _build.load_library().nb_fused_step_exact, pm, vel, aold, *out, n,
           min(int(n_real), n), float(dt), float(g), float(eps2), split)
    return out


def _exact_vs_parent(tag: str, split: int, got, parent_fn, *args) -> None:
    """With ``--parent``: ``got`` bit-equal to the parent's kernel at the
    same ``split``."""
    _parent_equal(f"{tag} (S = {split})", got, parent_fn, *args, split=split)


def phase_exact_checks(dev) -> None:
    """``force_exact`` and ``fused_step_exact`` (csrc/exact.cuh) against
    the twin, < 1e-5 of scale, with a 1e7 body and padded rows at N =
    8,192: at every S from 1 to 8, both rsqrt instances (EXACT_EPS2); the
    fused step bit-equal to ``force_exact`` at the same S + the torch
    Verlet; the wrapper's S; the ragged rectangular calls of EXACT_RAGGED.
    With ``--parent`` each bit-equal to the parent's kernel at the same S."""
    rng = np.random.default_rng(16)
    n, n_real = 8192, 8000
    pm, vel, aold = _inputs(rng, n, n_real, dev)
    pm[n // 3, 3] = 1e7
    for eps2 in EXACT_EPS2:
        want = cf.force_exact_plain(pm, pm, G, eps2)
        errs = {}
        for split in range(1, EXACT_MAX_SPLIT + 1):
            got = force_exact_split(pm, pm, G, eps2, split)
            fused = fused_exact_split(pm, vel, aold, DT, G, eps2, n_real, split)
            verlet = _verlet_on_card(pm, vel, aold, got, n_real)
            torch.cuda.synchronize()
            errs[split] = rel_err(got, want)
            check(errs[split] < 1e-5 and not got[:, 3].any() and bool(torch.isfinite(got).all())
                  and all(torch.equal(x, w) for x, w in zip(fused, verlet)),
                  f"N={n} eps2 {eps2:g} S={split}: force_exact vs plain with a 1e7 body {errs[split]:.3e} < 1e-5, "
                  "w lane 0; fused_step_exact bit-equal to force_exact + torch Verlet")
            _exact_vs_parent(f"N={n} eps2 {eps2:g} force_exact", split, got, parent_force_exact, pm, pm, G, eps2)
            _exact_vs_parent(f"N={n} eps2 {eps2:g} fused_step_exact", split, fused, parent_fused_step_exact, pm,
                             vel, aold, DT, G, eps2, n_real)
        split = exact_split(n, n, sm_count(dev.index))
        check(torch.equal(cf.force_exact(pm, pm, G, eps2), force_exact_split(pm, pm, G, eps2, split)),
              f"N={n} eps2 {eps2:g}: the wrapper launches S = exact_split = {split}")
        for n_t, n_s in EXACT_RAGGED:
            tgt, src = pm[-n_t:].contiguous(), pm[:n_s].contiguous()
            got, want = cf.force_exact(tgt, src, G, eps2), cf.force_exact_plain(tgt, src, G, eps2)
            one = force_exact_split(tgt, src, G, eps2, 1)
            torch.cuda.synchronize()
            e1 = rel_err(one, want)
            check(rel_err(got, want) < 1e-5 and e1 < 1e-5,
                  f"{n_t} x {n_s} eps2 {eps2:g}: force_exact vs plain, S = {exact_split(n_t, n_s, sm_count(dev.index))} "
                  f"{rel_err(got, want):.3e}, S = 1 {e1:.3e} < 1e-5")
            _exact_vs_parent(f"{n_t} x {n_s} eps2 {eps2:g} force_exact", 1, one, parent_force_exact, tgt, src, G, eps2)


# (N, tile, eps2): tile counts whose runs of hops are cut short (SYM_RUN =
# 8): nt = 2 (the half hop alone), 8 (3 hops, one short run, and the half
# hop), 19 (odd: 9 hops, 8 + 1), 35 (odd: 17, 8 + 8 + 1) and 36 (17 hops and
# the half hop); nt = 19 at eps2 = 1e-14, where eps2^3 is subnormal (the
# padded rows' d2^3 too), so the kernel takes rsqrtf with its guard; tiles of
# 512 and 1024 rows (the latter's shared memory above 48 KB).
SYM_RUN_SHAPES = ((512, 256, EPS2), (2048, 256, EPS2), (4864, 256, EPS2), (4480, 128, EPS2), (4608, 128, EPS2),
                  (4864, 256, 1e-14), (4608, 512, EPS2), (8192, 1024, EPS2))


def phase_sym_run_checks(dev) -> None:
    """``sym_hops`` against its twin (summed with the diagonal, as the
    force is) where a block's run of hops is cut short; a 1e7 body and
    padded rows, < 2e-5 of scale."""
    rng = np.random.default_rng(3)
    for n_pad, b, eps2 in SYM_RUN_SHAPES:
        nt = n_pad // b
        pm = _inputs(rng, n_pad, n_pad - 37, dev)[0]
        pm[n_pad // 3, 3] = 1e7
        src, acc_d = cf.sym_diag_prep(pm, G, eps2, b)
        acc_h, acc_h_p = cf.sym_hops(src, eps2, b), cf.sym_hops_plain(src, eps2, b)
        torch.cuda.synchronize()
        e = rel_err(acc_d + acc_h, acc_d + acc_h_p)
        check(e < 2e-5 and not acc_h[:, 3].any() and bool(torch.isfinite(acc_h).all()),
              f"N={n_pad} tile {b} nt={nt} eps2 {eps2:g} (launches (k0, nk, grid_i, runs) {hop_blocks(nt)}): "
              f"sym_hops vs plain with a 1e7 body (summed accel) {e:.3e} < 2e-5, finite, w lane 0")


def phase_kernel_times(dev) -> dict[str, dict]:
    """Each kernel beside its twin at the main-path shapes, same inputs."""
    out: dict[str, dict] = {}
    print("[3 kernels] times at main-path shapes (CUDA events)", flush=True)

    pm_np, vel_np, _ = make_preset("two-galaxy", seed=0, G=G)
    n_pad = pad_count(pm_np.shape[0], PAD_GRANULE)
    pm = init_state(pm_np, vel_np, n_pad=n_pad, device=dev).pos_mass
    ex = cf.force_exact(pm, pm, G, EPS2)
    ex_p = cf.force_exact_plain(pm, pm, G, EPS2)
    torch.cuda.synchronize()
    check(rel_err(ex, ex_p) < 1e-5, f"two-galaxy N={n_pad}: force_exact vs plain {rel_err(ex, ex_p):.3e} < 1e-5")
    out["force_exact"] = {
        "max_abs_err": max_abs(ex, ex_p),
        "ms": cuda_ms(lambda: cf.force_exact(pm, pm, G, EPS2), reps=20),
        "plain_ms": cuda_ms(lambda: cf.force_exact_plain(pm, pm, G, EPS2), reps=3),
        "shape": f"({n_pad}, 4) x ({n_pad}, 4)",
        **bound("force_exact", n_pad * n_pad, 48 * n_pad, rsqrts=n_pad * n_pad),
    }
    phase_vjp_two_galaxy(dev, pm, pm_np.shape[0])

    n = 262144
    b = GPU_TILE
    pm_np, vel_np, _ = make_preset("uniform-sphere", seed=0, G=G, n=n)
    st = init_state(pm_np, vel_np, n_pad=n, device=dev)
    pm, vel, acc = morton_reorder(st.pos_mass, st.vel, st.accel, n_real=n)
    src, acc_d = cf.sym_diag_prep(pm, G, EPS2, b)
    src_p, acc_d_p = cf.sym_diag_prep_plain(pm, G, EPS2, b)
    torch.cuda.synchronize()
    check(torch.equal(src, src_p) and rel_err(acc_d, acc_d_p) < 1e-5,
          f"uniform-sphere N={n}: sym_diag_prep src equal, acc {rel_err(acc_d, acc_d_p):.3e} < 1e-5")
    t = [cuda_ms(lambda e=e: cf.sym_diag_prep(pm, G, e, b), reps=20) for e in (1e-14, EPS2, EPS2, 1e-14)]
    print(f"  sym_diag_prep N={n}: in turns guarded rsqrtf (eps2 1e-14) {t[0]:.4f} / {t[3]:.4f} ms, ftz "
          f"{t[1]:.4f} / {t[2]:.4f} ms", flush=True)
    parent = {}
    if PARENT:
        _parent_equal(f"uniform-sphere N={n}: sym_diag_prep", (src, acc_d), parent_sym_diag_prep, pm, G, EPS2, b)
        parent = vs_parent(f"sym_diag_prep N={n}", lambda: cf.sym_diag_prep(pm, G, EPS2, b),
                           lambda: parent_sym_diag_prep(pm, G, EPS2, b))
    out["sym_diag_prep"] = {
        "max_abs_err": max_abs(acc_d, acc_d_p),
        "ms": cuda_ms(lambda: cf.sym_diag_prep(pm, G, EPS2, b), reps=20),
        "plain_ms": cuda_ms(lambda: cf.sym_diag_prep_plain(pm, G, EPS2, b), reps=2),
        "shape": f"({n}, 4), tile {b}",
        **bound("sym_diag_prep", n * (b - 1), 48 * n, rsqrts=n * (b - 1)),
        **parent,
    }
    del src_p, acc_d_p

    t0 = time.perf_counter()
    acc_h_p = cf.sym_hops_plain(src, EPS2, b)
    torch.cuda.synchronize()
    plain_hops_ms = (time.perf_counter() - t0) * 1e3
    acc_h = cf.sym_hops(src, EPS2, b)
    torch.cuda.synchronize()
    total_p = acc_d + acc_h_p
    check(rel_err(acc_d + acc_h, total_p) < 2e-5,
          f"uniform-sphere N={n}: sym_hops vs plain (summed accel) {rel_err(acc_d + acc_h, total_p):.3e} < 2e-5")
    parent = {}
    if PARENT:
        e_par = rel_err(acc_d + parent_sym_hops(src, EPS2, b), total_p)
        check(e_par < 2e-5, f"uniform-sphere N={n}: the parent's sym_hops vs plain (summed accel) {e_par:.3e} < 2e-5")
        parent = vs_parent(f"sym_hops N={n}", lambda: cf.sym_hops(src, EPS2, b),
                           lambda: parent_sym_hops(src, EPS2, b), reps=3)
    out["sym_hops"] = {
        "max_abs_err": max_abs(acc_h, acc_h_p),
        "ms": cuda_ms(lambda: cf.sym_hops(src, EPS2, b), reps=3),
        "plain_ms": plain_hops_ms,
        "shape": f"({n}, 4), tile {b}, nt {n // b}",
        **bound("sym_hops", hop_pairs(n, b), 32 * n, rsqrts=hop_pairs(n, b)),
        **parent,
    }
    del acc_h_p, total_p

    state_k = [t.clone() for t in (pm, vel, acc)]
    state_p = [t.clone() for t in (pm, vel, acc)]
    cf.sym_epilogue_(acc_d, acc_h, *state_k, DT, n - 5)
    cf.sym_epilogue_plain_(acc_d, acc_h, *state_p, DT, n - 5)
    torch.cuda.synchronize()
    err = max(max_abs(k, p) for k, p in zip(state_k, state_p))
    check(err == 0.0, f"uniform-sphere N={n}: sym_epilogue vs plain bit-equal (max-abs {err:.3e})")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)  # 128 MB > the 50 MB L2
    epi = lambda: cf.sym_epilogue_(acc_d, acc_h, *state_k, DT, n)  # noqa: E731
    epi_plain = lambda: cf.sym_epilogue_plain_(acc_d, acc_h, *state_p, DT, n)  # noqa: E731
    warm_ms = cuda_ms(epi, reps=50)
    out["sym_epilogue"] = {
        "max_abs_err": err,
        "ms": cuda_ms_cold(epi, 50, flush),
        "plain_ms": cuda_ms_cold(epi_plain, 20, flush),
        "shape": f"5 x ({n}, 4) in, 3 x ({n}, 4) out",
        "note": f"L2 flushed; L2 warm {warm_ms:.4f} ms, plain {cuda_ms(epi_plain, reps=20):.4f} ms",
        **bound("sym_epilogue", n, 128 * n),
    }
    del flush
    out.update(phase_vjp_times(dev, pm, b))
    _print_times(out)
    return out


# ------------------------------------------------------------- VJP kernels
def _cotangent(rng, n_pad: int, n_real: int, dev) -> torch.Tensor:
    abar = np.concatenate([rng.standard_normal((n_pad, 3)), np.zeros((n_pad, 1))], axis=1)
    abar[n_real:] = 0.0
    return torch.from_numpy(abar.astype(np.float32)).to(dev)


def _parts_err(got: tuple, want: tuple) -> tuple[float, float, float]:
    """(x̄, m̄, Ḡ) errors of ``(pm_bar, gbar)`` pairs: max-abs over scale
    for x̄ and m̄, relative for Ḡ."""
    (p, g), (pw, gw) = got, want
    return (rel_err(p[:, :3], pw[:, :3]), rel_err(p[:, 3], pw[:, 3]),
            abs(float(g) - float(gw)) / abs(float(gw)))


def vjp_full_split(pm, g: float, abar, eps2: float, split: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``vjp_full``'s launch with ``split`` CTAs a block of rows (the
    wrapper passes ``exact_split``'s): ``(pm_bar, gbar)``."""
    pm_bar = torch.empty_like(pm)
    gbar = torch.zeros(1, dtype=torch.float64, device=pm.device)
    launch("vjp_full", pm.device, _build.load_library().nb_vjp_full, pm, abar, pm_bar, gbar, pm.shape[0], float(g),
           float(eps2), split)
    return pm_bar, gbar


def _twin_inputs(pm, abar, eps2: float):
    """The twins' inputs: as given, or in f64 where eps2 is subnormal in
    f32.  The twins mask the self pair by a product, and at such an eps2 its
    f32 w = eps2^-3/2 overflows (inf * 0); in f64 its terms are 0."""
    return (pm, abar) if eps2 >= FLT_MIN else (pm.double(), abar.double())


def _gbar_scale(pm, abar, eps2: float, chunk: int = 512) -> float:
    """The scale of Ḡ's terms, sum_k |A_k . F_k| in f64 (F per unit G): Ḡ
    is a sum of terms of either sign, so its error is held to this, as x̄'s
    and m̄'s are held to their largest entry."""
    x, m, a = pm[:, :3].double(), pm[:, 3].double(), abar[:, :3].double()
    total = 0.0
    for s in range(0, pm.shape[0], chunk):
        d = x[None] - x[s : s + chunk, None]
        w = (torch.sum(d * d, dim=-1) + eps2) ** -1.5
        total += float(torch.sum(a[s : s + chunk] * torch.einsum("kj,j,kjc->kc", w, m, d), dim=1).abs().sum())
    return total


def _full_checks(tag: str, pm, abar, eps2: float, want=None) -> None:
    """``vjp_full`` at every S from 1 to 8 against the twin (``want``: its
    output, else run here, in f64 where eps2 is subnormal, see
    :func:`_twin_inputs`): x̄ and m̄ < 1e-5 of their scale, Ḡ < 1e-5 of the
    scale of its terms (:func:`_gbar_scale`); the wrapper's S printed and
    equal to its launch at that S; with ``--parent`` S = 1 bit-equal to the
    parent's kernel (pm_bar; Ḡ, summed in double by atomics, to 1e-12)."""
    if want is None:
        p, a = _twin_inputs(pm, abar, eps2)
        want = fv.vjp_full_plain(p, G, a, eps2)
    scale = _gbar_scale(pm, abar, eps2)
    split = exact_split(pm.shape[0], pm.shape[0], sm_count(pm.device.index))
    for s in range(1, EXACT_MAX_SPLIT + 1):
        got = vjp_full_split(pm, G, abar, eps2, s)
        torch.cuda.synchronize()
        ex, em = rel_err(got[0][:, :3], want[0][:, :3].float()), rel_err(got[0][:, 3], want[0][:, 3].float())
        eg = abs(float(got[1]) - float(want[1]))
        check(ex < 1e-5 and em < 1e-5 and eg / scale < 1e-5 and bool(torch.isfinite(got[0]).all()),
              f"{tag}: vjp_full at S = {s} vs plain x̄ {ex:.3e}, m̄ {em:.3e} < 1e-5, Ḡ {eg / scale:.3e} of "
              f"sum |A.F| < 1e-5 ({eg / abs(float(want[1])):.3e} of |Ḡ|), finite")
    wrapper = fv.vjp_full(pm, G, abar, eps2)
    check(torch.equal(wrapper[0], vjp_full_split(pm, G, abar, eps2, split)[0]),
          f"{tag}: the wrapper launches vjp_full at S = exact_split = {split}")
    if PARENT:
        got, par = vjp_full_split(pm, G, abar, eps2, 1), parent_vjp_full(pm, G, abar, eps2)
        torch.cuda.synchronize()
        eg = abs(float(got[1]) - float(par[1])) / abs(float(par[1]))
        check(torch.equal(got[0], par[0]) and eg < 1e-12,
              f"{tag}: vjp_full at S = 1 bit-equal to the parent's kernel (largest difference "
              f"{_ulps(got[0], par[0])} ulp), Ḡ {eg:.3e} < 1e-12")


def _diag_checks(tag: str, pm, abar, eps2: float, b: int, acc_d, acc_d_p=None) -> float:
    """``vjp_sym_diag`` against its twin (``acc_d_p``, else run here as
    :func:`_full_checks` runs its twin), < 1e-5 of each column's scale,
    finite, columns 5-7 zero; with ``--parent`` bit-equal to the parent's
    kernel where the runtime width takes the tile (b != 256: the first
    design's order; b = 256 takes the Newton-3 instance, another order).
    Returns the worst column's error."""
    if acc_d_p is None:
        acc_d_p = fv.vjp_sym_diag_plain(*_twin_inputs(pm, abar, eps2), eps2, b)
    e_d = max(rel_err(acc_d[:, c], acc_d_p[:, c].float()) for c in range(5))
    check(e_d < 1e-5 and not acc_d[:, 5:].any() and bool(torch.isfinite(acc_d).all()),
          f"{tag}: vjp_sym_diag vs plain, worst column {e_d:.3e} < 1e-5, finite, columns 5-7 zero")
    if b != GPU_TILE:
        _parent_equal(f"{tag}: vjp_sym_diag", acc_d, parent_vjp_sym_diag, pm, abar, eps2, b)
    return e_d


def phase_vjp_checks(dev) -> None:
    """The four VJP kernels vs their plain twins, padded rows included
    (``vjp_full`` at every S, :func:`_full_checks`)."""
    print("[3 kernels] VJP kernel vs plain twin, small shapes (heavy body 1e5)", flush=True)
    rng = np.random.default_rng(1)
    for n_pad, b, n_real in [(8192, 256, 8000), (7936, 256, 7900), (512, 256, 500)]:
        nt = n_pad // b
        pm, _, _ = _inputs(rng, n_pad, n_real, dev)
        pm[0, 3] = 1e5
        abar = _cotangent(rng, n_pad, n_real, dev)
        tag = f"N={n_pad} nt={nt}"
        acc_d, acc_d_p = fv.vjp_sym_diag(pm, abar, EPS2, b), fv.vjp_sym_diag_plain(pm, abar, EPS2, b)
        acc_h, acc_h_p = fv.vjp_sym_hops(pm, abar, EPS2, b), fv.vjp_sym_hops_plain(pm, abar, EPS2, b)
        torch.cuda.synchronize()
        _diag_checks(tag, pm, abar, EPS2, b, acc_d, acc_d_p)
        sym_k = fv.vjp_combine(acc_d, acc_h, G)
        sym_p = fv.vjp_combine_plain(acc_d_p, acc_h_p, G)
        ex, em, eg = _parts_err(sym_k, sym_p)
        check(ex < 2e-5 and em < 2e-5 and eg < 1e-5,
              f"{tag}: diag+hops+combine vs plain stages x̄ {ex:.3e}, m̄ {em:.3e} < 2e-5, Ḡ {eg:.3e} < 1e-5")
        comb_p = fv.vjp_combine_plain(acc_d, acc_h, G)
        eq = torch.equal(sym_k[0], comb_p[0])
        eg = abs(float(sym_k[1]) - float(comb_p[1])) / abs(float(comb_p[1]))
        check(eq and eg < 1e-12, f"{tag}: vjp_combine vs plain pm_bar bit-equal, Ḡ {eg:.3e} < 1e-12")
        full_k = fv.vjp_full(pm, G, abar, EPS2)
        full_p = fv.vjp_full_plain(pm, G, abar, EPS2)
        torch.cuda.synchronize()
        ex, em, eg = _parts_err(full_k, full_p)
        check(ex < 1e-5 and em < 1e-5 and eg < 1e-5,
              f"{tag}: vjp_full vs plain x̄ {ex:.3e}, m̄ {em:.3e}, Ḡ {eg:.3e} < 1e-5")
        _full_checks(tag, pm, abar, EPS2, full_p)
        ex, em, eg = _parts_err(sym_k, full_k)
        check(ex < 2e-5 and em < 2e-5 and eg < 1e-5,
              f"{tag}: sym schedule vs full grid x̄ {ex:.3e}, m̄ {em:.3e} < 2e-5, Ḡ {eg:.3e} < 1e-5")
        pad0 = bool((sym_k[0][n_real:, :3] == 0).all() and (full_k[0][n_real:, :3] == 0).all())
        check(pad0 and bool(torch.isfinite(sym_k[0]).all()), f"{tag}: padded rows' x̄ exactly 0, all finite")
    phase_vjp_run_checks(dev)


def _hops_err(acc_d, acc_h, acc_h_p) -> float:
    """``vjp_sym_hops`` against its twin summed with the diagonal, as the
    VJP sums them: the worst of the five columns' max-abs over scale."""
    return max(rel_err(acc_d[:, c] + acc_h[:, c], acc_d[:, c] + acc_h_p[:, c]) for c in range(5))


# (N, tile, eps2) of vjp_sym_hops' run checks: SYM_RUN_SHAPES' tile counts
# (runs of hops cut short) and tiles (512 and 1024 rows: shared memory above
# 48 KB), eps2 = 1e-40 (subnormal: the kernel takes rsqrtf with its guard;
# no padded rows there, whose coincident pairs would make w overflow).
VJP_RUN_SHAPES = tuple((n, b, 1e-40 if eps2 < EPS2 else eps2) for n, b, eps2 in SYM_RUN_SHAPES)


def phase_vjp_run_checks(dev) -> None:
    """``vjp_sym_hops`` against its twin where a block's run of hops is cut
    short, at tiles of 512 and 1024 and a subnormal eps2, with a 1e7 body
    and padded rows, and on ``pair_checks.vjp_heavy``; < 2e-5 of scale
    (summed with the diagonal), the parent's kernel too with ``--parent``.
    At the same shapes ``vjp_sym_diag`` (:func:`_diag_checks`: the template
    width and the runtime one, both rsqrt instances) and ``vjp_full``
    (:func:`_full_checks`)."""
    rng = np.random.default_rng(4)
    cases = [(f"N={n} tile {b} eps2 {eps2:g}", _inputs(rng, n, n - (37 if eps2 >= EPS2 else 0), dev)[0], b, eps2)
             for n, b, eps2 in VJP_RUN_SHAPES]
    pm_h, abar_h = (torch.from_numpy(a).to(dev) for a in pair_checks.vjp_heavy())
    for tag, pm, b, eps2 in cases + [("pair_checks.vjp_heavy N=1024 tile 256", pm_h, 256, EPS2)]:
        if pm is pm_h:
            abar = abar_h
        else:
            pm[pm.shape[0] // 3, 3] = 1e7
            abar = _cotangent(rng, pm.shape[0], int((pm[:, 3] != 0).sum()), dev)
        acc_d = fv.vjp_sym_diag(pm, abar, eps2, b)
        acc_h, acc_h_p = fv.vjp_sym_hops(pm, abar, eps2, b), fv.vjp_sym_hops_plain(pm, abar, eps2, b)
        torch.cuda.synchronize()
        _diag_checks(tag, pm, abar, eps2, b, acc_d)
        _full_checks(tag, pm, abar, eps2)
        e = _hops_err(acc_d, acc_h, acc_h_p)
        check(e < 2e-5 and not acc_h[:, 5:].any() and bool(torch.isfinite(acc_h).all()),
              f"{tag} (launches (k0, nk, grid_i, runs) {hop_blocks(pm.shape[0] // b)}): vjp_sym_hops vs plain "
              f"with a 1e7 body (summed with diag), worst column {e:.3e} < 2e-5, finite, columns 5-7 zero")
        if PARENT:
            e_par = _hops_err(acc_d, parent_vjp_sym_hops(pm, abar, eps2, b), acc_h_p)
            check(e_par < 2e-5, f"{tag}: the parent's vjp_sym_hops vs plain, worst column {e_par:.3e} < 2e-5")


def _vjp_oracle_f64(pm: np.ndarray, abar: np.ndarray, rows: np.ndarray, chunk: int = 64):
    """float64 numpy closed form of the VJP for the target ``rows``, each
    summed over every source (grad_bench.py's oracle).  Returns (x̄ (R, 3),
    m̄ (R,), the rows' φ (R,)), x̄ and m̄ scaled by G."""
    x = pm[:, :3].astype(np.float64)
    m = pm[:, 3].astype(np.float64)
    A = abar[:, :3].astype(np.float64)
    xbar, mbar, phi = np.empty((len(rows), 3)), np.empty(len(rows)), np.empty(len(rows))
    for c0 in range(0, len(rows), chunk):
        k = rows[c0 : c0 + chunk]
        d = x[None, :, :] - x[k, None, :]
        r2 = np.sum(d * d, axis=-1) + EPS2
        mask = np.ones(r2.shape)
        mask[np.arange(len(k)), k] = 0.0
        w = mask * r2**-1.5
        w5 = mask * r2**-2.5
        g = m[k, None, None] * A[None, :, :] - m[None, :, None] * A[k, None, :]
        dg = np.sum(d * g, axis=-1)
        xbar[c0 : c0 + len(k)] = np.sum(w[:, :, None] * g, axis=1) - 3.0 * np.einsum("kj,kjc->kc", w5 * dg, d)
        mbar[c0 : c0 + len(k)] = -np.einsum("kj,kjc,jc->k", w, d, A)
        phi[c0 : c0 + len(k)] = np.einsum("kc,kj,j,kjc->k", A[k], w, m, d)
    return G * xbar, G * mbar, phi


def _oracle_errs(pm_bar: np.ndarray, xbar_o, mbar_o, rows) -> tuple[float, float, float]:
    """Median and p99 relative x̄ error per body, median relative m̄ error."""
    scale = np.linalg.norm(xbar_o, axis=1)
    floor = 1e-12 * np.median(scale)
    rel = np.linalg.norm(pm_bar[rows, :3] - xbar_o, axis=1) / (scale + floor)
    rel_m = np.abs(pm_bar[rows, 3] - mbar_o) / (np.abs(mbar_o) + floor)
    return float(np.median(rel)), float(np.quantile(rel, 0.99)), float(np.median(rel_m))


def phase_vjp_gate(dev) -> None:
    """grad_bench.py's accuracy gate: both schedules against f64 at N = 4,096."""
    n = 4096
    pm_np, _, _ = make_preset("uniform-sphere", seed=0, G=G, n=n)
    pm_np = np.asarray(pm_np, np.float32)
    abar_np = np.concatenate(
        [np.random.default_rng(3).standard_normal((n, 3)), np.zeros((n, 1))], axis=1
    ).astype(np.float32)
    rows = np.arange(n)
    xbar_o, mbar_o, phi_o = _vjp_oracle_f64(pm_np, abar_np, rows)
    gbar_o = float(phi_o.sum())
    pm, abar = torch.from_numpy(pm_np).to(dev), torch.from_numpy(abar_np).to(dev)
    for name, (pm_bar, gbar) in (
        ("full", fv.force_vjp(pm, G, abar, eps2=EPS2)),
        ("sym", fv.force_vjp_sym(pm, G, abar, eps2=EPS2, b=GPU_TILE)),
    ):
        med, p99, med_m = _oracle_errs(pm_bar.cpu().numpy(), xbar_o, mbar_o, rows)
        rel_g = abs(float(gbar) - gbar_o) / abs(gbar_o)
        check(med <= 1e-4 and med_m <= 1e-4,
              f"[3 vjp gate] uniform-sphere N={n} {name}: x̄ median rel err {med:.3e} (p99 {p99:.3e}), "
              f"m̄ median {med_m:.3e} <= 1e-4 vs f64; Ḡ rel err {rel_g:.3e}")


def phase_vjp_two_galaxy(dev, pm: torch.Tensor, n_real: int) -> None:
    """The sym VJP at the exact gradient path's shape and data (two-galaxy,
    n_pad 40,192, tile 256, nt = 157 odd; two 1e7-mass centres beside
    bodies of mass 10-50) on a random cotangent: each stage against its
    plain twin, the whole against the plain stages and the full-grid VJP
    (the limits of the N = 262,144 checks), and both schedules against f64
    on 256 rows (the two centres among them)."""
    n, b = pm.shape[0], GPU_TILE
    tag = f"two-galaxy N={n} nt={n // b}"
    abar = _cotangent(np.random.default_rng(8), n, n_real, dev)
    acc_d, acc_d_p = fv.vjp_sym_diag(pm, abar, EPS2, b), fv.vjp_sym_diag_plain(pm, abar, EPS2, b)
    acc_h, acc_h_p = fv.vjp_sym_hops(pm, abar, EPS2, b), fv.vjp_sym_hops_plain(pm, abar, EPS2, b)
    torch.cuda.synchronize()
    _diag_checks(tag, pm, abar, EPS2, b, acc_d, acc_d_p)
    e_h = _hops_err(acc_d, acc_h, acc_h_p)
    check(e_h < 2e-5, f"{tag}: vjp_sym_hops vs plain (summed with diag), worst column {e_h:.3e} < 2e-5")
    if PARENT:
        e_par = _hops_err(acc_d, parent_vjp_sym_hops(pm, abar, EPS2, b), acc_h_p)
        check(e_par < 2e-5, f"{tag}: the parent's vjp_sym_hops vs plain, worst column {e_par:.3e} < 2e-5")
        vs_parent(f"{tag} vjp_sym_hops", lambda: fv.vjp_sym_hops(pm, abar, EPS2, b),
                  lambda: parent_vjp_sym_hops(pm, abar, EPS2, b), reps=10)
        vs_parent(f"{tag} vjp_sym_diag", lambda: fv.vjp_sym_diag(pm, abar, EPS2, b),
                  lambda: parent_vjp_sym_diag(pm, abar, EPS2, b), reps=20)
        vs_parent(f"{tag} vjp_full (S = {exact_split(n, n, sm_count(dev.index))})", lambda: fv.vjp_full(pm, G, abar, EPS2),
                  lambda: parent_vjp_full(pm, G, abar, EPS2), reps=5)
        vjp_guarded_rsqrt(tag, pm, abar, b, reps=10, full_reps=5)
    _full_checks(tag, pm, abar, EPS2)
    vjp_full_by_split(tag, pm, abar)
    sym = fv.force_vjp_sym(pm, G, abar, eps2=EPS2, b=b)
    full = fv.force_vjp(pm, G, abar, eps2=EPS2)
    for what, want in (("plain stages", fv.vjp_combine_plain(acc_d_p, acc_h_p, G)), ("full-grid VJP", full)):
        ex, em, eg = _parts_err(sym, want)
        check(ex < 2e-5 and em < 2e-5 and eg < 1e-5,
              f"{tag}: sym VJP vs {what} x̄ {ex:.3e}, m̄ {em:.3e} < 2e-5, Ḡ {eg:.3e} < 1e-5")
    heavy = torch.topk(pm[:, 3], 2).indices.cpu().numpy()
    rng = np.random.default_rng(9)
    rows = np.union1d(heavy, rng.choice(np.setdiff1d(np.arange(n_real), heavy), 254, replace=False))
    xbar_o, mbar_o, _ = _vjp_oracle_f64(pm.cpu().numpy(), abar.cpu().numpy(), rows)
    for name, (pm_bar, _) in (("sym", sym), ("full", full)):
        med, p99, med_m = _oracle_errs(pm_bar.cpu().numpy(), xbar_o, mbar_o, rows)
        check(med <= 1e-4 and med_m <= 1e-4,
              f"{tag} {name} VJP vs f64 on 256 rows: x̄ median rel err {med:.3e} "
              f"(p99 {p99:.3e}), m̄ median {med_m:.3e} <= 1e-4")


def vjp_full_by_split(tag: str, pm, abar, reps: int = 5) -> None:
    """``vjp_full``'s launch at every S from 1 to 8 (CUDA events), beside
    the S that ``exact_split`` gives it."""
    split = exact_split(pm.shape[0], pm.shape[0], sm_count(pm.device.index))
    t = {s: cuda_ms(lambda s=s: vjp_full_split(pm, G, abar, EPS2, s), reps=reps) for s in range(1, EXACT_MAX_SPLIT + 1)}
    print(f"  {tag} vjp_full by S (exact_split gives {split}): "
          + ", ".join(f"S={s} {ms:.4f} ms" for s, ms in t.items()), flush=True)


def phase_vjp_times(dev, pm: torch.Tensor, b: int) -> dict[str, dict]:
    """The VJP kernels at the sym main-path shape (N = 262,144, tile 256)
    on a random cotangent: times beside the twins', and the full-width
    checks (sym vs full grid, both vs f64 on 256 sampled rows)."""
    n = pm.shape[0]
    out: dict[str, dict] = {}
    abar = _cotangent(np.random.default_rng(5), n, n, dev)
    acc_d = fv.vjp_sym_diag(pm, abar, EPS2, b)
    acc_d_p = fv.vjp_sym_diag_plain(pm, abar, EPS2, b)
    torch.cuda.synchronize()
    e_d = _diag_checks(f"uniform-sphere N={n}", pm, abar, EPS2, b, acc_d, acc_d_p)
    parent = {}
    if PARENT:
        parent = vs_parent(f"vjp_sym_diag N={n}", lambda: fv.vjp_sym_diag(pm, abar, EPS2, b),
                           lambda: parent_vjp_sym_diag(pm, abar, EPS2, b))
    # The function needs each unordered pair of a tile once (the Newton-3
    # count, at vjp_sym_hops' FLOP a pair): the bound.  The ordered count,
    # n(b-1) pairs at the first design's FLOP, beside it in the note.
    ordered = bound("vjp_sym_diag", n * (b - 1), 64 * n, rsqrts=n * (b - 1))
    out["vjp_sym_diag"] = {
        "max_abs_err": max_abs(acc_d, acc_d_p),
        "note": f"worst column max-abs/scale {e_d:.3e}; bound by the ordered count {ordered['bound_ms']:.4f} ms "
                f"({ordered['bound_by']})",
        "ms": cuda_ms(lambda: fv.vjp_sym_diag(pm, abar, EPS2, b), reps=20),
        "plain_ms": cuda_ms(lambda: fv.vjp_sym_diag_plain(pm, abar, EPS2, b), reps=2),
        "shape": f"2 x ({n}, 4) -> ({n}, 8), tile {b}",
        **bound("vjp_sym_hops", n * (b - 1) // 2, 64 * n, rsqrts=n * (b - 1) // 2),
        **parent,
    }
    del acc_d_p

    acc_h_p = None

    def run_plain_hops():
        nonlocal acc_h_p
        acc_h_p = fv.vjp_sym_hops_plain(pm, abar, EPS2, b)

    plain_hops_ms = host_ms(run_plain_hops)
    acc_h = fv.vjp_sym_hops(pm, abar, EPS2, b)
    torch.cuda.synchronize()
    e_h = _hops_err(acc_d, acc_h, acc_h_p)
    check(e_h < 2e-5, f"uniform-sphere N={n}: vjp_sym_hops vs plain (summed with diag), worst column {e_h:.3e} < 2e-5")
    parent = {}
    if PARENT:
        e_par = _hops_err(acc_d, parent_vjp_sym_hops(pm, abar, EPS2, b), acc_h_p)
        check(e_par < 2e-5, f"uniform-sphere N={n}: the parent's vjp_sym_hops vs plain, worst column {e_par:.3e} < 2e-5")
        parent = vs_parent(f"vjp_sym_hops N={n}", lambda: fv.vjp_sym_hops(pm, abar, EPS2, b),
                           lambda: parent_vjp_sym_hops(pm, abar, EPS2, b), reps=3)
        vjp_guarded_rsqrt(f"uniform-sphere N={n}", pm, abar, b, reps=3, full_reps=2)
    out["vjp_sym_hops"] = {
        "max_abs_err": max_abs(acc_h, acc_h_p),
        "ms": cuda_ms(lambda: fv.vjp_sym_hops(pm, abar, EPS2, b), reps=3),
        "plain_ms": plain_hops_ms,
        "shape": f"2 x ({n}, 4) -> ({n}, 8), tile {b}, nt {n // b}",
        "note": f"plain: one run, host clock; worst column max-abs/scale {e_h:.3e}",
        **bound("vjp_sym_hops", hop_pairs(n, b), 64 * n, rsqrts=hop_pairs(n, b)),
        **parent,
    }
    del acc_h_p

    sym = fv.vjp_combine(acc_d, acc_h, G)
    comb_p = fv.vjp_combine_plain(acc_d, acc_h, G)
    torch.cuda.synchronize()
    check(torch.equal(sym[0], comb_p[0]), f"uniform-sphere N={n}: vjp_combine vs plain pm_bar bit-equal")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    pm_bar, gbar = torch.empty((n, 4), device=dev), torch.zeros(1, dtype=torch.float64, device=dev)
    lib = _build.load_library()
    # The launch alone: the wrapper's zeroing of gbar is a kernel of its own.
    comb = lambda: launch("vjp_combine", dev, lib.nb_vjp_combine, acc_d, acc_h, pm_bar, gbar, n, G)  # noqa: E731
    comb_plain = lambda: fv.vjp_combine_plain(acc_d, acc_h, G)  # noqa: E731
    warm_ms = cuda_ms(comb, reps=50)
    out["vjp_combine"] = {
        "max_abs_err": max_abs(sym[0], comb_p[0]),
        "ms": cuda_ms_cold(comb, 50, flush),
        "plain_ms": cuda_ms_cold(comb_plain, 20, flush),
        "shape": f"2 x ({n}, 8) -> ({n}, 4) + Ḡ",
        "note": f"L2 flushed; L2 warm {warm_ms:.4f} ms, plain {cuda_ms(comb_plain, reps=20):.4f} ms",
        **bound("vjp_combine", n, 80 * n + 8),
    }
    del flush

    full = fv.vjp_full(pm, G, abar, EPS2)
    full_p = None

    def run_plain_full():
        nonlocal full_p
        full_p = fv.vjp_full_plain(pm, G, abar, EPS2)

    plain_full_ms = host_ms(run_plain_full)
    ex, em, eg = _parts_err(full, full_p)
    split = exact_split(n, n, sm_count(dev.index))
    check(ex < 1e-5 and em < 1e-5 and eg < 1e-5,
          f"uniform-sphere N={n}: vjp_full (S = {split}) vs plain x̄ {ex:.3e}, m̄ {em:.3e}, Ḡ {eg:.3e} < 1e-5")
    parent = {}
    if PARENT:
        one, par = vjp_full_split(pm, G, abar, EPS2, 1), parent_vjp_full(pm, G, abar, EPS2)
        torch.cuda.synchronize()
        eg = abs(float(one[1]) - float(par[1])) / abs(float(par[1]))
        check(torch.equal(one[0], par[0]) and eg < 1e-12,
              f"uniform-sphere N={n}: vjp_full at S = 1 bit-equal to the parent's kernel (largest difference "
              f"{_ulps(one[0], par[0])} ulp), Ḡ {eg:.3e} < 1e-12")
        del one, par
        parent = vs_parent(f"vjp_full N={n} (S = {split})", lambda: fv.vjp_full(pm, G, abar, EPS2),
                           lambda: parent_vjp_full(pm, G, abar, EPS2), reps=2)
    out["vjp_full"] = {
        "max_abs_err": max_abs(full[0], full_p[0]),
        "ms": cuda_ms(lambda: fv.vjp_full(pm, G, abar, EPS2), reps=2),
        "plain_ms": plain_full_ms,
        "shape": f"2 x ({n}, 4) -> ({n}, 4) + Ḡ, S {split}",
        "note": "plain: one run, host clock",
        **bound("vjp_full", n * (n - 1), 48 * n + 8, rsqrts=n * (n - 1)),
        **parent,
    }
    del full_p

    ex, em, eg = _parts_err(sym, full)
    check(ex < 2e-5 and em < 2e-5 and eg < 1e-5,
          f"uniform-sphere N={n}: sym VJP vs full-grid VJP x̄ {ex:.3e}, m̄ {em:.3e} < 2e-5, Ḡ {eg:.3e} < 1e-5")
    rows = np.sort(np.random.default_rng(6).choice(n, 256, replace=False))
    xbar_o, mbar_o, _ = _vjp_oracle_f64(pm.cpu().numpy(), abar.cpu().numpy(), rows)
    for name, (pm_bar, _) in (("sym", sym), ("full", full)):
        med, p99, med_m = _oracle_errs(pm_bar.cpu().numpy(), xbar_o, mbar_o, rows)
        check(med <= 1e-4 and med_m <= 1e-4,
              f"uniform-sphere N={n} {name} VJP vs f64 on 256 rows: x̄ median rel err {med:.3e} "
              f"(p99 {p99:.3e}), m̄ median {med_m:.3e} <= 1e-4")
    return out


# --------------------------------------------------------------- gradients
def _rollout_times(step, pm: torch.Tensor, v0: torch.Tensor, k: int, loss_of, reps: int = 2):
    """Forward and gradient (by v0) of a k-step rollout loss: median host
    ms per step of each, the gradient, and the two rollouts as
    ``[(label, fn)]`` for :func:`profile_window`."""

    def forward():
        s = SimState(pm.clone(), v0.clone(), torch.zeros_like(pm), 0)
        for _ in range(k):
            s = step(s, DT_MAIN, G)
        return loss_of(s)

    def gradient():
        v = v0.clone().requires_grad_()
        s = SimState(pm.clone(), v, torch.zeros_like(pm), 0)
        for _ in range(k):
            s = step(s, DT_MAIN, G)
        return torch.autograd.grad(loss_of(s), v)[0]

    forward(), gradient()  # warm
    t_f = statistics.median(host_ms(forward) for _ in range(reps)) / k
    out = {}
    t_g = statistics.median(host_ms(lambda: out.update(g=gradient())) for _ in range(reps)) / k
    return t_f, t_g, out["g"], [(f"forward, {k} steps", forward), (f"gradient, {k} steps", gradient)]


def _kernel_label(name: str) -> str:
    m = re.search(r"(\w+)[<(]", name)
    return m.group(1) if m else name[:40]


def _profiled(fn):
    """One call of ``fn()`` under ``torch.profiler`` (CPU + CUDA): host wall
    time in us, the device events as ``(label, start, end)``, and whether
    the trace holds one event for every launch of the port's kernels."""
    from torch.profiler import ProfilerActivity, profile

    before = launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launched = {k: c - before[k] for k, c in launch_counts().items() if c > before[k]}
    events = [(_kernel_label(e.name), e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = {k: sum(1 for name, _, _ in events if name in TRACE_NAMES.get(k, (f"{k}_kernel",))) for k in launched}
    return wall_us, events, seen == launched


# The device functions of a counted kernel where they are not "<name>_kernel"
# (mesh_gather: the loop alone and the box kernel, csrc/mesh_gather.cu;
# vjp_sym_diag: the ordered loop and the Newton-3 one at tile 256).
TRACE_NAMES = {"mesh_gather": ("mesh_gather_kernel", "mesh_gather_box_kernel"),
               "vjp_sym_diag": ("vjp_sym_diag_kernel", "vjp_sym_diag_n3_kernel")}


# Stages of a mesh step by kernel name (lower case; the first key found wins).
STAGES = (
    ("short_range_bwd", "short_range_bwd"), ("short_range", "short_range"),
    ("mesh_deposit", "mesh_deposit"), ("mesh_gather", "mesh_gather"), ("fft", "FFT (cuFFT)"),
    ("sort", "sorts (Morton order, selection top-k)"), ("index", "indexing (gathers, index_put)"),
    ("scatter", "indexing (gathers, index_put)"), ("gather", "indexing (gathers, index_put)"),
    ("reduce", "reductions"),
)


def _stage(label: str) -> str:
    low = label.lower()
    return next((stage for key, stage in STAGES if key in low), "elementwise and other torch ops")


def _busy_us(events) -> float:
    """The device's busy time in a trace: the union of its events' intervals."""
    if not events:
        return 0.0
    spans = sorted((s, e) for _, s, e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    return busy + hi - lo


def profile_window(label: str, fn, tries: int = 3, stages: bool = False, per_launch: tuple[str, ...] = ()) -> None:
    """Host wall time, device busy time (the union of the intervals of the
    device's kernels and copies), the idle share 1 - busy / wall and the
    three largest kernels of one call of ``fn()``; with ``stages``, each
    stage's share of the summed kernel time (:data:`STAGES`); for each
    counted kernel of ``per_launch``, its launches in the trace and their
    mean device time.  A trace that misses a launch of the port's kernels
    (the profiler has dropped device events on the card) is taken again, up
    to ``tries`` times."""
    for attempt in range(1, tries + 1):
        wall_us, events, complete = _profiled(fn)
        if complete and events:
            break
    else:
        print(f"  profile {label}: no trace in {tries} held every kernel launch; "
              "device busy time not measured", flush=True)
        return
    busy = _busy_us(events)
    per_kernel: dict[str, float] = {}
    for name, s, e in events:
        per_kernel[name] = per_kernel.get(name, 0.0) + e - s
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:3]
    print(f"  profile {label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"idle share {1 - busy / wall_us:.4f} (trace {attempt} of {tries}); top: "
          + ", ".join(f"{n} {t / 1e3:.3f} ms" for n, t in top), flush=True)
    for k in per_launch:
        spans_k = [e - s for name, s, e in events if name in TRACE_NAMES.get(k, (f"{k}_kernel",))]
        if spans_k:
            print(f"  profile {label}: {k} {len(spans_k)} launches, mean device time a launch "
                  f"{sum(spans_k) / len(spans_k) / 1e3:.5f} ms (its inputs as its path leaves them)", flush=True)
    if stages:
        by_stage: dict[str, float] = {}
        for name, t in per_kernel.items():
            by_stage[_stage(name)] = by_stage.get(_stage(name), 0.0) + t
        total = sum(by_stage.values())
        print(f"  profile {label}, stages (share of {total / 1e3:.3f} ms summed kernel time): "
              + ", ".join(f"{n} {t / 1e3:.3f} ms {t / total:.1%}"
                          for n, t in sorted(by_stage.items(), key=lambda kv: -kv[1])), flush=True)


def _grad_agrees(g: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    """``|g - ref| <= 2e-3 |ref| + 1e-6 max|ref|`` elementwise."""
    atol = 1e-6 * float(ref.abs().max())
    excess = float(((g - ref).abs() - 2e-3 * ref.abs()).max())
    check(excess <= atol, f"{what}: rtol 2e-3, atol 1e-6 of scale "
          f"(worst |diff| - rtol|ref| = {excess:.3e} <= {atol:.3e}; max |diff| / max |ref| "
          f"{max_abs(g, ref) / float(ref.abs().max()):.3e})")


def _two_galaxy(dev):
    pm_np, vel_np, _ = make_preset("two-galaxy", seed=0, G=G)
    n_real = pm_np.shape[0]
    return init_state(pm_np, vel_np, n_pad=pad_count(n_real, PAD_GRANULE), device=dev), n_real


GRADS: dict[str, torch.Tensor] = {}  # phase 6b's gradient, for phase 6c


def _print_grad(tag: str, n_pair: int, t_f: float, t_g: float, forward: str = "forward") -> None:
    print(f"{tag}: {forward} {t_f:.4f} ms/step, gradient {t_g:.4f} ms/step, ratio {t_g / t_f:.3f}, "
          f"gradient pair rate 2N^2/t {2 * n_pair * n_pair / t_g / 1e6:.2f} G-pair/s", flush=True)


def phase_grad_sym(dev):
    """grad_bench's rollout: uniform-sphere N = 262,144, k = 5, by v0."""
    n, k = 262144, 5
    pm_np, vel_np, _ = make_preset("uniform-sphere", seed=0, G=G, n=n)
    st = init_state(pm_np, vel_np, n_pad=n, device=dev)
    step = make_step_fn(SimConfig(force_mode="sym"), n, n, dev)
    t_f, t_g, g, prof = _rollout_times(step, st.pos_mass, st.vel, k, lambda s: (s.pos_mass[:, :3] ** 2).sum() / n)
    _print_grad(f"[6a grad sym] uniform-sphere N={n} k={k}", n, t_f, t_g)
    check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, "sym gradient finite and nonzero")
    return [(f"sym {label}", fn, {"per_launch": ("vjp_combine",)}) for label, fn in prof]


def phase_grad_exact(dev):
    """The exact route's rollout gradient at two-galaxy N = 40,002, k = 3."""
    st, n_real = _two_galaxy(dev)
    k = 3
    step = make_step_fn(SimConfig(), st.n_pad, n_real, dev)
    t_f, t_g, g, prof = _rollout_times(
        step, st.pos_mass, st.vel, k, lambda s: (s.pos_mass[:, :3] ** 2).sum() / n_real)
    # The forward needs no gradient, so it runs fused_step_exact; the
    # gradient runs force_exact + the torch Verlet under autograd.
    _print_grad(f"[6b grad exact] two-galaxy N={n_real} (n_pad {st.n_pad}) k={k}", st.n_pad, t_f, t_g,
                forward="forward (the fused step)")
    check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, "exact gradient finite and nonzero")
    GRADS["exact"] = g
    return [(f"exact {label}", fn) for label, fn in prof]


def phase_grad_full(dev):
    """Phase 6b's rollout through ``make_diff_accel(sym=False)``, the
    full-grid VJP route (on no main path), against phase 6b's gradient; with
    ``--parent`` it hands back the same rollout with the parent's
    ``vjp_full`` as the backward, in turns with this tree's (parent, this,
    this, parent), to run after the window's counts are read."""
    st, n_real = _two_galaxy(dev)
    k = 3
    force = lambda p, g: cf.force_exact(p, p, g, EPS2)  # noqa: E731
    accel = fv.make_diff_accel(force, eps2=EPS2, b=GPU_TILE, sym=False)

    def stepper(acc):
        return lambda s, dt, g: integrate_state("verlet", lambda p: acc(p, g), s, dt, n_real=n_real)

    def rollout(acc):
        return _rollout_times(stepper(acc), st.pos_mass, st.vel, k, lambda s: (s.pos_mass[:, :3] ** 2).sum() / n_real)

    t_f, t_g, g, _ = rollout(accel)
    _print_grad(f"[6c grad full-grid VJP] two-galaxy N={n_real} (n_pad {st.n_pad}) k={k}", st.n_pad, t_f, t_g)
    _grad_agrees(g, GRADS["exact"], "full-grid VJP route vs phase 6b's gradient")
    if PARENT:
        def parent_backward(pm, g_, abar):
            pm_bar, gbar = parent_vjp_full(pm, g_, abar, EPS2)
            return pm_bar, gbar.to(torch.float32).reshape(())

        parent_accel = lambda p, g_: fv._DiffAccel.apply(p, g_, force, parent_backward)  # noqa: E731

        def in_turns():
            t = [rollout(a)[1] for a in (parent_accel, accel, accel, parent_accel)]
            print(f"  6c gradient ms/step with the parent's vjp_full beside this tree's (same card, in turns "
                  f"parent, this, this, parent): parent {t[0]:.4f} / {t[3]:.4f}, this {t[1]:.4f} / {t[2]:.4f}",
                  flush=True)

        return [in_turns]
    return []


def phase_grad_crosscheck(dev, n: int = 4096) -> None:
    """tests/test_grad.py's rollout (10 steps, dt 1e-2, loss |x_0|^2) at
    N = 4,096 on the card: kernel routes vs the backend="jnp" route, the
    gradient by v0 and by dt and G (0-d tensors)."""
    rng = np.random.default_rng(7)
    pm = torch.from_numpy(np.concatenate(
        [rng.standard_normal((n, 3)), rng.uniform(10, 50, (n, 1))], axis=1).astype(np.float32)).to(dev)
    full_accel = fv.make_diff_accel(lambda p, g: cf.force_exact(p, p, g, EPS2), eps2=EPS2, b=GPU_TILE, sym=False)
    steps = {
        "jnp": make_step_fn(SimConfig(backend="jnp"), n, n, dev),
        "sym": make_step_fn(SimConfig(force_mode="sym"), n, n, dev),
        "exact": make_step_fn(SimConfig(), n, n, dev),
        "exact, full-grid VJP": lambda s, dt_, g: integrate_state("verlet", lambda p: full_accel(p, g), s, dt_),
    }
    grads = {}
    for name, step in steps.items():
        v = torch.zeros((n, 4), device=dev, requires_grad=True)
        dt, g = (torch.tensor(x, device=dev, requires_grad=True) for x in (1e-2, G))
        s = SimState(pm.clone(), v, torch.zeros_like(pm), 0)
        for _ in range(10):
            s = step(s, dt, g)
        grads[name] = torch.autograd.grad((s.pos_mass[0, :3] ** 2).sum(), (v, dt, g))
    ref_v, ref_dt, ref_g = grads.pop("jnp")
    for name, (gv, gdt, gg) in grads.items():
        _grad_agrees(gv, ref_v, f"[6d grad check] N={n} {name} route vs jnp route")
        e_dt, e_g = (abs(float(a) - float(b)) / abs(float(b)) for a, b in ((gdt, ref_dt), (gg, ref_g)))
        check(e_dt <= 2e-3 and e_g <= 2e-3,
              f"[6d grad check] N={n} {name} route: d/d dt {float(gdt):.6e} (rel err {e_dt:.3e}), "
              f"d/dG {float(gg):.6e} (rel err {e_g:.3e}) vs jnp route, rtol 2e-3")


def _conservation(sim: Simulation, d0, d1):
    e0, e1 = float(d0.total_energy), float(d1.total_energy)
    drift = abs(e1 - e0) / max(abs(e0), 1e-30)
    pm, vel, _ = sim.arrays()
    pscale = float(np.abs(pm[:, 3:4] * vel[:, :3]).sum())
    mom = float(np.max(np.abs(np.asarray(d1.momentum) - np.asarray(d0.momentum)))) / max(pscale, 1e-30)
    finite = all(np.isfinite(a).all() for a in sim.arrays())
    return drift, mom, finite


def _timed_chunks(sim: Simulation, chunks: int, chunk: int, step=None) -> list[float]:
    """Host seconds of each of ``chunks`` chunks of ``sim.run``, or with
    ``step`` of ``run_chunk`` over it on the simulation's state (for a
    simulation that neither re-sorts nor wraps)."""
    times = []
    for _ in range(chunks):
        t0 = time.perf_counter()
        if step is None:
            sim.run(chunk, chunk=chunk)
        else:
            sim.state = run_chunk(step, sim.state, sim.dt, sim.G, chunk)
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def _composed_step(mode: str, n_real: int):
    """``force_exact`` or ``force_fast`` and the torch Verlet, spelled out:
    the route of a Verlet step that needs a gradient, and what the fused
    kernel equals bit for bit."""
    force = cf.force_exact if mode == "exact" else cf.force_fast
    return lambda s, dt, g: integrate_state("verlet", lambda p: force(p, p, g, EPS2), s, dt, n_real=n_real)


def _exact_run(dev, tag: str, mesh=None, composed: str | None = None, **kw) -> float:
    """two-galaxy N = 40,002 (the reference default) with ``kw``: 200 steps
    in chunks of 50, energy drift <= 1e-3, momentum error <= 1e-5; with
    ``composed`` the chunks run ``_composed_step(composed)`` on the
    simulation's state.  Returns the median ms/step."""
    sim = Simulation.from_preset("two-galaxy", SimConfig(**kw), device=None if mesh else dev, mesh=mesh)
    d0 = sim.diagnostics()
    times = _timed_chunks(sim, 4, 50, _composed_step(composed, sim.n_real) if composed else None)
    d1 = sim.diagnostics()
    drift, mom, finite = _conservation(sim, d0, d1)
    med = statistics.median(times)
    gints = sim.pair_interactions_per_step * 50 / med / 1e9
    print(
        f"[{tag}] two-galaxy N={sim.n_real} (n_pad {sim.n_pad}) {kw} 200 steps: "
        f"median chunk {med:.4f} s = {med / 50 * 1e3:.4f} ms/step, {gints:.2f} G-int/s; "
        f"chunks {[round(t, 4) for t in times]}; energy drift {drift:.3e}, momentum err {mom:.3e}",
        flush=True,
    )
    check(finite and sim.state.pos_mass.shape == (sim.n_pad, 4), f"{tag}: finite state of shape (n_pad, 4)")
    check(drift <= 1e-3, f"{tag}: energy drift {drift:.3e} <= 1e-3")
    check(mom <= 1e-5, f"{tag}: momentum error {mom:.3e} <= 1e-5")
    return med / 50 * 1e3


def _sphere_run(dev, tag: str, chunk: int, mesh=None, **kw) -> tuple[float, Simulation]:
    """uniform-sphere N = 262,144, ``morton_every=64``, sym unless ``kw``
    names another force_mode: 1 warm and 2 timed chunks, energy drift <=
    1e-4 * max(steps, 140) / 140, momentum error <= 1e-5.  Returns the
    median ms/step and the simulation."""
    cfg = SimConfig(**{"force_mode": "sym", "morton_every": 64, **kw})
    sim = Simulation.from_preset("uniform-sphere", cfg, n=262144, device=None if mesh else dev, mesh=mesh)
    d0 = sim.diagnostics()
    warm = _timed_chunks(sim, 1, chunk)
    times = _timed_chunks(sim, 2, chunk)
    d1 = sim.diagnostics()
    nsteps = 3 * chunk
    drift, mom, finite = _conservation(sim, d0, d1)
    med = statistics.median(times)
    gints = sim.pair_interactions_per_step * chunk / med / 1e9
    bound = 1e-4 * max(nsteps, 140) / 140.0
    evals = sim.pair_interactions_per_step // (sim.n_real * sim.n_real - sim.n_real)
    print(
        f"[{tag}] uniform-sphere N={sim.n_real} morton_every=64 {kw} {nsteps} steps: median chunk "
        f"{med:.4f} s = {med / chunk * 1e3:.4f} ms/step, {gints:.2f} G-int/s ({evals} force evaluations a step); "
        f"warm {warm[0]:.4f} s, timed {[round(t, 4) for t in times]}; energy drift {drift:.3e} "
        f"({drift / nsteps:.3e}/step), momentum err {mom:.3e}",
        flush=True,
    )
    check(finite and sim.state.pos_mass.shape == (sim.n_pad, 4), f"{tag}: finite state of shape (n_pad, 4)")
    check(drift <= bound, f"{tag}: energy drift {drift:.3e} <= {bound:.3e}")
    check(mom <= 1e-5, f"{tag}: momentum error {mom:.3e} <= 1e-5")
    return med / chunk * 1e3, sim


# Phase 4's and 5's ms/step, printed beside phase 10's.
MAIN: dict[str, float] = {}


def phase_exact(dev) -> None:
    MAIN["phase 4"] = _exact_run(dev, "4 exact")


def phase_sym(dev) -> None:
    MAIN["phase 5"] = _sphere_run(dev, "5 sym", chunk=50)[0]


# ------------------------------------------- the parent's kernels (--parent)
PARENT: dict = {}  # the kernel library of a checkout of the parent commit


def load_parent(path: str) -> None:
    """Build the kernels of a checkout of the parent commit at ``path`` with
    its own ``_build.py`` (into its own build directory), to hold its
    kernels beside this tree's on one card."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("parent_build", pathlib.Path(path) / "nbody3d_tpu_torch" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    PARENT["lib"] = mod.load_library()
    print(f"[parent] kernels of {path} built", flush=True)
    sym_kernel_report("parent", mod.build_log(), mod.build()[0])


def _parent_call(fn, *args) -> None:
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"parent kernel: CUDA error {rc}")


def parent_deposit(c4, fm, grid: int, order: int, periodic: bool) -> torch.Tensor:
    """The parent's ``mesh_deposit`` (this tree's C signature; no block-path counter)."""
    rho = torch.zeros(grid**3, device=fm.device)
    _parent_call(PARENT["lib"].nb_mesh_deposit, c4, fm, rho, c4.shape[0], grid, order, int(periodic), None)
    return rho


def parent_resolve(prep, w: int, h: int) -> torch.Tensor:
    """The parent's ``splat_resolve`` (this tree's C signature)."""
    buf = torch.full((h * w,), resolve.MISS, dtype=torch.int64, device=prep[0].device)
    _parent_call(PARENT["lib"].nb_splat_resolve, *prep, buf, prep[0].shape[0], w, h)
    return buf


def parent_sym_hops(src, eps2: float, b: int) -> torch.Tensor:
    """The parent's ``sym_hops`` (this tree's C signature and launches,
    ``hop_blocks``)."""
    acc = torch.zeros_like(src)
    nt = src.shape[0] // b
    for k0, nk, grid_i, runs in hop_blocks(nt):
        _parent_call(PARENT["lib"].nb_sym_hops, src, acc, nt, b, k0, nk, grid_i, runs, float(eps2))
    return acc


def parent_pair_sym(tgt, src, g: float, eps2: float, b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The parent's ``pair_sym`` (this tree's C signature)."""
    acc_t, acc_s = torch.zeros_like(tgt), torch.zeros_like(src)
    ns = src.shape[0] // b
    _parent_call(PARENT["lib"].nb_pair_sym, tgt, src, acc_t, acc_s, tgt.shape[0] // b, ns, sym_runs(ns), b,
                 float(g), float(eps2))
    return acc_t, acc_s


def parent_short_range(ps, nbr_idx, eps2: float, sigma, rcut, block: int, mask, box: float | None = None):
    """The parent's ``short_range`` (this tree's C signature and dense
    flags)."""
    ids, msk, scal = p3m._kernel_operands("short_range", ps.device, nbr_idx, mask, sigma, rcut)
    dense = None if box is not None else p3m._dense_slots(ps, ids, block, rcut)
    out = torch.empty_like(ps)
    _parent_call(PARENT["lib"].nb_short_range, ps, ids, msk, dense, scal, out, nbr_idx.shape[0], nbr_idx.shape[1],
                 block, float(eps2), float(box or 0.0))
    return out


def parent_vjp_sym_hops(pm, abar, eps2: float, b: int) -> torch.Tensor:
    """The parent's ``vjp_sym_hops`` (this tree's C signature and launches,
    ``hop_blocks``)."""
    acc = torch.zeros((pm.shape[0], 8), dtype=torch.float32, device=pm.device)
    nt = pm.shape[0] // b
    for k0, nk, grid_i, runs in hop_blocks(nt):
        _parent_call(PARENT["lib"].nb_vjp_sym_hops, pm, abar, acc, nt, b, k0, nk, grid_i, runs, float(eps2))
    return acc


def parent_vjp_sym_diag(pm, abar, eps2: float, b: int) -> torch.Tensor:
    """The parent's ``vjp_sym_diag`` (this tree's C signature)."""
    acc = torch.empty((pm.shape[0], 8), dtype=torch.float32, device=pm.device)
    _parent_call(PARENT["lib"].nb_vjp_sym_diag, pm, abar, acc, pm.shape[0] // b, b, float(eps2))
    return acc


def parent_vjp_full(pm, g: float, abar, eps2: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The parent's ``vjp_full`` (its C signature: no split): ``(pm_bar, gbar)``."""
    pm_bar = torch.empty_like(pm)
    gbar = torch.zeros(1, dtype=torch.float64, device=pm.device)
    _parent_call(PARENT["lib"].nb_vjp_full, pm, abar, pm_bar, gbar, pm.shape[0], float(g), float(eps2))
    return pm_bar, gbar


def parent_force_fast(tgt, src, g: float, eps2: float, diag=cf.SELF_DIAG) -> torch.Tensor:
    """The parent's ``force_fast`` (this tree's C signature and operands:
    the wrapper's limb fragments)."""
    out = torch.empty_like(tgt)
    frag = cf.fragment_order(cf.limbs_bf16(src, g))
    _parent_call(PARENT["lib"].nb_force_fast, tgt, src, frag, out, tgt.shape[0], src.shape[0], float(eps2),
                 *(int(x) for x in diag))
    return out


def parent_fused_step_fast(pm, vel, aold, dt: float, g: float, eps2: float, n_real: int):
    """The parent's ``fused_step_fast`` (this tree's C signature)."""
    n = pm.shape[0]
    out = tuple(torch.empty_like(pm) for _ in range(3))
    _parent_call(PARENT["lib"].nb_fused_step_fast, pm, cf.fragment_order(cf.limbs_bf16(pm, g)), vel, aold, *out, n,
                 min(int(n_real), n), float(dt), float(eps2))
    return out


def parent_force_exact(tgt, src, g: float, eps2: float, split: int = 1) -> torch.Tensor:
    """The parent's ``force_exact`` (this tree's C signature) with ``split``
    CTAs a block of rows."""
    out = torch.empty_like(tgt)
    _parent_call(PARENT["lib"].nb_force_exact, tgt, src, out, tgt.shape[0], src.shape[0], float(g), float(eps2),
                 split)
    return out


def parent_fused_step_exact(pm, vel, aold, dt: float, g: float, eps2: float, n_real: int, split: int = 1):
    """The parent's ``fused_step_exact`` (this tree's C signature) with
    ``split`` CTAs a block of rows."""
    n = pm.shape[0]
    out = tuple(torch.empty_like(pm) for _ in range(3))
    _parent_call(PARENT["lib"].nb_fused_step_exact, pm, vel, aold, *out, n, min(int(n_real), n), float(dt),
                 float(g), float(eps2), split)
    return out


def parent_sym_diag_prep(pm, g: float, eps2: float, b: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The parent's ``sym_diag_prep`` (this tree's C signature): ``(src, acc_diag)``."""
    src, acc = torch.empty_like(pm), torch.empty_like(pm)
    _parent_call(PARENT["lib"].nb_sym_diag_prep, pm, src, acc, pm.shape[0] // b, b, float(g), float(eps2))
    return src, acc


def parent_gather(grids, c4, fm, grid: int, order: int, periodic: bool, sorted_rows: bool = True) -> torch.Tensor:
    """The parent's ``mesh_gather`` (this tree's C signature, no block-path
    counter): the kernel ``sorted_rows`` picks."""
    out = torch.empty_like(fm)
    _parent_call(PARENT["lib"].nb_mesh_gather, grids, c4, fm, out, c4.shape[0], grid, order, int(periodic),
                 int(sorted_rows), None)
    return out


def parent_short_range_bwd(ps, g, nbr_idx, eps2: float, sigma, rcut, block: int, mask, box: float | None = None):
    """The parent's ``short_range_bwd`` (this tree's C signature and dense
    flags), as ``p3m.short_range_tiles_bwd`` returns it."""
    ids, msk, scal = p3m._kernel_operands("short_range_bwd", ps.device, nbr_idx, mask, sigma, rcut)
    dense = p3m._slot_flags("short_range_bwd", ps, ids, block, rcut, box, None)
    dps = torch.empty_like(ps)
    dsig = torch.empty(ps.shape[0], dtype=torch.float32, device=ps.device)
    _parent_call(PARENT["lib"].nb_short_range_bwd, ps, g, ids, msk, dense, scal, dps, dsig, nbr_idx.shape[0],
                 nbr_idx.shape[1], block, float(eps2), float(box or 0.0))
    return dps, torch.sum(dsig)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in f32 units in the last place between a and b
    (elementwise, both finite), by their ordered int32 patterns."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(1 << 31) - i, i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def _parent_equal(tag: str, got, parent_fn, *args, **kwargs) -> None:
    """With ``--parent``: ``got`` (a tensor or a tuple of them) equal bit for
    bit to the parent's kernel, ``parent_fn(*args, **kwargs)``; else the
    largest ulp difference is printed."""
    if not PARENT:
        return
    want = parent_fn(*args, **kwargs)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{tag} bit-equal to the parent's kernel (largest difference "
          f"{max(_ulps(a, b) for a, b in zip(got, want))} ulp)")


def _bwd_parent_equal(tag: str, got, args: tuple, box: float | None = None) -> None:
    """:func:`_parent_equal` for ``short_range_bwd`` on ``args`` (those of
    ``p3m.short_range_tiles_bwd``): x̄, m̄ and the summed σ̄."""
    _parent_equal(f"{tag}: short_range_bwd", got, parent_short_range_bwd, *args, box=box)


def _bwd_vs_parent(tag: str, got, args: tuple, box: float | None = None, reps: int = 3) -> dict:
    """With ``--parent``: :func:`_bwd_parent_equal`, and both kernels timed
    in turns; {} without."""
    if not PARENT:
        return {}
    _bwd_parent_equal(tag, got, args, box)
    return vs_parent(f"{tag} short_range_bwd", lambda: p3m.short_range_tiles_bwd(*args, box=box),
                     lambda: parent_short_range_bwd(*args, box=box), reps=reps)


def vs_guarded_rsqrt(tag: str, name: str, run, reps: int) -> None:
    """A VJP kernel's two instances timed in turns (guarded, ftz, ftz,
    guarded; CUDA events, ``reps`` launches each of ``run(eps2)``): the one
    eps2 = 1e-40 selects (``rsqrtf`` with its subnormal guard) and the one
    the main paths' eps2 selects (the ftz rsqrt, eps2 >= FLT_MIN).  The
    same pairs and instructions but the rsqrt's."""
    t = [cuda_ms(run(e), reps=reps) for e in (1e-40, EPS2, EPS2, 1e-40)]
    print(f"    {tag} {name}, rsqrtf with its guard (eps2 = 1e-40) beside the ftz rsqrt (eps2 = {EPS2:g}), "
          f"in turns: guarded {t[0]:.4f} / {t[3]:.4f} ms, ftz {t[1]:.4f} / {t[2]:.4f} ms", flush=True)


def vjp_guarded_rsqrt(tag: str, pm, abar, b: int, reps: int, full_reps: int) -> None:
    """:func:`vs_guarded_rsqrt` for the three pair kernels of the VJP."""
    vs_guarded_rsqrt(tag, "vjp_sym_hops", lambda e: lambda: fv.vjp_sym_hops(pm, abar, e, b), reps)
    vs_guarded_rsqrt(tag, "vjp_sym_diag", lambda e: lambda: fv.vjp_sym_diag(pm, abar, e, b), 20)
    vs_guarded_rsqrt(tag, "vjp_full", lambda e: lambda: fv.vjp_full(pm, G, abar, e), full_reps)


def vs_parent(tag: str, fn, parent_fn, reps: int = 20) -> dict:
    """``fn`` and the parent's ``parent_fn`` timed in turns (parent, this,
    this, parent; CUDA events, ``reps`` launches each): their mean ms."""
    t = [cuda_ms(f, reps=reps) for f in (parent_fn, fn, fn, parent_fn)]
    out = {"parent_ms": (t[0] + t[3]) / 2, "this_ms": (t[1] + t[2]) / 2}
    print(f"    {tag} beside the parent's kernel (same card, in turns parent, this, this, parent): parent "
          f"{t[0]:.4f} / {t[3]:.4f} ms, this {t[1]:.4f} / {t[2]:.4f} ms", flush=True)
    return out


# ------------------------------------------------------- the render path
def render_scene(n: int, seed: int, *, scale: float = 2.5, heavy: int = 2, masses=None):
    """tests/test_render.py's scene (benchmarks/render_bench.py's at
    N = 500,010): bodies N(0, scale), masses U(10, 50), the first ``heavy``
    at 1e7 (or ``masses``), velocities N(0, 5)."""
    rng = np.random.default_rng(seed)
    pos_mass = np.concatenate(
        [rng.normal(scale=scale, size=(n, 3)), rng.uniform(10, 50, (n, 1))], axis=1
    ).astype(np.float32)
    if masses is not None:
        pos_mass[: len(masses), 3] = masses
    elif heavy:
        pos_mass[:heavy, 3] = 1e7
    vel = rng.normal(scale=5.0, size=(n, 4)).astype(np.float32)
    return pos_mass, vel


def _two_galaxy_frame():
    """The run's frame: the two-galaxy preset, its camera, 1024x768."""
    cfg = SimConfig()
    pm, vel, target = make_preset("two-galaxy", seed=cfg.seed, G=cfg.G, size_factor=cfg.size_factor)
    return pm, vel, Camera(target=target), dict(width=1024, height=768, size_factor=cfg.size_factor)


def render_scenes() -> dict:
    """name: (pos_mass, vel, camera, frame kwargs).  The scenes of
    tests/test_render.py:312-430 and the two-galaxy frame."""
    scenes = {
        "20k dense, 320x240": (*render_scene(20_000, 13), 4.0, dict(width=320, height=240)),
        "6k bin edges, 640x100": (*render_scene(6_000, 7, heavy=0), 2.0, dict(width=640, height=100)),
        "3k radii 16-64, 320x240": (*render_scene(3_000, 11, scale=2.0, masses=np.geomspace(1e5, 5e9, 64)), 2.0,
                                    dict(width=320, height=240)),
        "1.5k max_radius_px 96, 256x160": (*render_scene(1_500, 12, scale=2.0, masses=[5e10] * 4), 2.0,
                                           dict(width=256, height=160, max_radius_px=96)),
    }
    # tests/test_render.py's size factors clamp every radius to 0.5 px at
    # this frame height; about 160 / sf is the least radius, so 160.2, 113.3
    # and 80.2 spread radii from just below r = 1, sqrt 2 and 2 upwards.
    for sf in (400.0, 700.0, 1000.0, 1800.0, 160.2, 113.3, 80.2):
        scenes[f"r = 1, sqrt 2, 2 sweep, size_factor {sf:g}"] = (
            *render_scene(512, 3, scale=1.0, heavy=0), 5.0, dict(width=200, height=160, size_factor=sf))
    out = {k: (pm, vel, Camera(target=np.zeros(3), radius=rad), fr) for k, (pm, vel, rad, fr) in scenes.items()}
    out["two-galaxy N=40,002, 1024x768"] = _two_galaxy_frame()
    return out


def _prep(pm, vel, cam, frame, dev):
    """The device prep's resolve inputs on the card."""
    pm, vel = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pm, vel))
    return rasterize.prep_device(pm, vel, cam, frame["width"], frame["height"],
                                 frame.get("size_factor", 1000.0), frame.get("max_radius_px", 64))


def phase_render_checks(dev) -> None:
    """7a: ``splat_resolve`` against its twin on the same prep, bit for bit:
    the scenes of tests/test_render.py, the two-galaxy frame and
    :func:`resolve_adversarial`'s."""
    print("[7a render] splat_resolve vs plain twin on the card (uint64 framebuffer, torch.equal)", flush=True)
    preps = {name: (_prep(pm, vel, cam, frame, dev), frame["width"], frame["height"])
             for name, (pm, vel, cam, frame) in render_scenes().items()}
    for name, (*arrays, w, h) in resolve_adversarial().items():
        preps[name] = ([torch.from_numpy(a).to(dev) for a in arrays], w, h)
    for name, (prep, w, h) in preps.items():
        want = resolve.splat_resolve_plain(*prep, width=w, height=h)
        same = torch.equal(resolve.splat_resolve(*prep, width=w, height=h), want)
        vis, r = prep[5], prep[4][prep[5]]
        lit = int((want != resolve.MISS).sum())
        check(same and lit > 0,
              f"{name}: kernel == twin ({int(vis.sum())} visible splats, r "
              f"{float(r.min()):.3f}-{float(r.max()):.3f} px, {lit} pixels lit)")


def stamp_pairs(prep, width: int, height: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Every (flat pixel, key) pair of the visible splats' discs: the input
    of one ``scatter_reduce_(..., "amin")`` (the library yardstick); its
    length is the stamp area."""
    cx, cy, depth_bits, rgb24, r, visible = prep
    rd = r[visible].double()
    order = torch.argsort(-rd, stable=True)
    cx, cy = (t[visible][order].long() for t in (cx, cy))
    key = resolve.make_keys(depth_bits[visible], rgb24[visible])[order]
    pairs = list(resolve.offset_pairs(cx, cy, key, rd[order].cpu().numpy(), width, height))
    return torch.cat([p for p, _ in pairs]), torch.cat([k for _, k in pairs])


def splat_bound(n: int, n_visible: int, width: int, height: int) -> dict:
    """The least bytes the resolve must move, over HBM: every splat's 1-byte
    ``visible`` flag, the visible splats' other 20 bytes (cx, cy, depth, rgb,
    r: 4 each), and each 8-byte framebuffer word written once (the frame
    fits in L2, so the atomics' read-modify-write need not reach HBM)."""
    return {"bound_ms": (n + 20 * n_visible + 8 * width * height) / HBM_BYTES * 1e3, "bound_by": "bytes"}


def _render_times(name, pm, vel, cam, frame, dev, tmp: pathlib.Path) -> dict:
    w, h = frame["width"], frame["height"]
    prep = _prep(pm, vel, cam, frame, dev)
    got = resolve.splat_resolve(*prep, width=w, height=h)
    want = None

    def run_plain():
        nonlocal want
        want = resolve.splat_resolve_plain(*prep, width=w, height=h)

    plain_ms = host_ms(run_plain)
    check(torch.equal(got, want), f"{name}: kernel == twin")
    pix, key = stamp_pairs(prep, w, h)
    top = torch.iinfo(torch.int64).max
    lib_call = lambda: torch.full((h * w,), top, dtype=torch.int64, device=dev).scatter_reduce_(  # noqa: E731
        0, pix, key, "amin")
    lib_buf = lib_call()
    check(torch.equal(torch.where(lib_buf == top, resolve.MISS, lib_buf), got), f"{name}: scatter_reduce_ == kernel")
    ms = cuda_ms(lambda: resolve.splat_resolve(*prep, width=w, height=h), reps=20)
    library_ms = cuda_ms(lib_call, reps=20)
    radii = torch.floor(prep[4][prep[5]]).long().clamp(max=9).bincount(minlength=10).tolist()
    parent = {}
    if PARENT:
        check(torch.equal(parent_resolve(prep, w, h), got), f"{name}: the parent's kernel == this one")
        parent = vs_parent(name, lambda: resolve.splat_resolve(*prep, width=w, height=h),
                           lambda: parent_resolve(prep, w, h))
    pm_d, vel_d = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pm, vel))
    rasterize.render_points(pm_d, vel_d, cam, **frame)  # warm
    frame_ms = statistics.median(host_ms(lambda: rasterize.render_points(pm_d, vel_d, cam, **frame)) for _ in range(3))
    img = rasterize.render_points(pm_d, vel_d, cam, **frame)
    t0 = time.perf_counter()
    save_png(str(tmp / "frame.png"), img)
    png_ms = (time.perf_counter() - t0) * 1e3
    n_vis = int(prep[5].sum())
    r = {
        "max_abs_err": float((got - want).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "shape": f"{pm.shape[0]} splats ({n_vis} visible) -> {w}x{h}",
        "note": (f"stamp area {pix.numel()} pixels ({pix.numel() / max(n_vis, 1):.2f} a splat), "
                 f"{int((got != resolve.MISS).sum())} lit; frame end to end {frame_ms:.3f} ms; "
                 f"PNG write {png_ms:.3f} ms; ms includes the framebuffer fill; plain: one run, host clock"),
        **parent,
        **splat_bound(pm.shape[0], n_vis, w, h),
    }
    print(f"  {name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library {library_ms:.4f} ms  "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  [{r['shape']}; {r['note']}]", flush=True)
    print(f"    visible splats by floor(r) 0..8, 9+: {radii}", flush=True)
    return r




def phase_render_times(dev) -> dict[str, dict]:
    """7c: the kernel, its twin and the library call at the run's frame
    (two-galaxy, 1024x768) and at benchmarks/render_bench.py's N = 500,010
    at 1920x1080 (camera radius 5 and 1); frame, PNG and checkpoint times."""
    print("[7c render] times (CUDA events; frame, PNG, checkpoint: host clock, synced)", flush=True)
    pm, vel = render_scene(500_010, 0)
    big = dict(width=1920, height=1080)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        main = _render_times("two-galaxy N=40,002 1024x768", *_two_galaxy_frame(), dev, tmp)
        scenes = {
            label: _render_times(f"N=500,010 1920x1080 {label}", pm, vel, Camera(target=np.zeros(3), radius=rad),
                                 big, dev, tmp)
            for rad, label in ((5.0, "default distance"), (1.0, "close-up"))
        }
        sim = Simulation.from_preset("two-galaxy", SimConfig(), device=dev)
        ck = {}
        for fmt in ("npz", "json"):
            path = str(tmp / f"c.{fmt}")
            ck[f"{fmt} save"] = host_ms(lambda: sim.save(path))
            ck[f"{fmt} load"] = host_ms(lambda: Simulation.load(path, device=dev))
        print(f"  checkpoint two-galaxy N={sim.n_real}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ck.items()),
              flush=True)
    main["scenes"] = {k: {x: v[x] for x in ("ms", "plain_ms", "library_ms", "bound_ms", "note", "parent_ms",
                                            "this_ms") if x in v}
                      for k, v in scenes.items()}
    return {"splat_resolve": main}


def phase_render_path(dev, out: pathlib.Path):
    """7b: the reference-default run through the CLI on the card, then
    ``render`` and ``convert`` of its final checkpoint, all into ``out``."""
    argv = ["run", "--device", dev.type, "--preset", "two-galaxy", "--steps", "200", "--log-every", "50",
            "--diagnostics", "--render-every", "50", "--checkpoint-every", "100", "--outdir", str(out)]
    print(f"[7b render path] cli {' '.join(argv)}", flush=True)
    sim0 = Simulation.from_preset("two-galaxy", SimConfig(), device=dev)
    d0 = sim0.diagnostics()
    del sim0
    t0 = time.perf_counter()
    rc = cli.main(argv)
    run_s = time.perf_counter() - t0
    names = sorted(p.name for p in out.iterdir())
    want = [f"frame_{i:06d}.png" for i in range(5)] + ["ckpt_00000100.npz", "ckpt_00000200.npz", "final.npz"]
    check(rc == 0 and all(n in names for n in want), f"run rc {rc} in {run_s:.3f} s wrote {names}")
    final = str(out / "final.npz")
    sim = Simulation.load(final, device=dev)
    drift, mom, finite = _conservation(sim, d0, sim.diagnostics())
    check(finite and sim.step_count == 200, f"final.npz: step {sim.step_count}, finite state")
    check(drift <= 1e-3 and mom <= 1e-5, f"run: energy drift {drift:.3e} <= 1e-3, momentum error {mom:.3e} <= 1e-5")
    t0 = time.perf_counter()
    rc = cli.main(["render", final, "-o", str(out / "render.png"), "--device", dev.type])
    render_s = time.perf_counter() - t0
    last, again = read_png(str(out / "frame_000004.png")), read_png(str(out / "render.png"))
    check(rc == 0 and np.array_equal(last, again) and last.any(),
          f"render final.npz ({render_s:.3f} s) == the run's last frame {last.shape}, "
          f"{int(last.any(axis=2).sum())} pixels lit")
    rc_a = cli.main(["convert", final, str(out / "x.json"), "--device", dev.type])
    rc_b = cli.main(["convert", str(out / "x.json"), str(out / "y.npz"), "--device", dev.type])
    with np.load(final) as a, np.load(out / "y.npz") as b:
        same = all(np.array_equal(a[k], b[k]) for k in ("pos_mass", "vel", "accel", "step"))
    check(rc_a == rc_b == 0 and same, "convert final.npz -> x.json -> y.npz: pos_mass, vel, accel, step bit-equal")
    return [("two-galaxy frame 1024x768", lambda: sim.render_frame())]


# ------------------------------------------------------ the mesh solvers
MESH_KERNELS = ("short_range", "mesh_deposit", "mesh_gather")
# 8b's bodies: two galaxies of 2^20 disk bodies and a 1e7 centre each.  The
# preset's n counts the centres, so n = 2,097,152 (p3m_bench's 2M, also 8d's)
# makes 8,192 tiles of 256, the flat selection's last size; these two more
# bodies pad to 2,097,408 rows = 8,193 tiles, odd, so the two-level selection
# runs with super-tiles of one tile.
P3M_N = 2_097_154
PM_N = 2_097_152


def _clustered(n: int, n_pad: int, dev, seed: int = 0):
    """The two-galaxy preset at ``n`` bodies (two 1e7 centres among them),
    zero-padded to ``n_pad`` rows on ``dev``: ``(pos_mass, vel, n_real)``."""
    pm_np, vel_np, _ = make_preset("two-galaxy", seed=seed, G=G, n=n)
    st = init_state(pm_np, vel_np, n_pad=n_pad, device=dev)
    return st.pos_mass, st.vel, pm_np.shape[0]


def _p3m_inputs(pos_mass: torch.Tensor, n_real: int, grid: int, block: int, nbr_k: int = 32):
    """What ``accel_p3m`` hands its kernels: the Morton-sorted mesh rows,
    the box, sigma and rcut, the TSC operands and the neighbour lists."""
    lo, h = pm._box(pos_mass[:n_real, :3], grid)
    sigma = p3m.DEFAULT_SIGMA_CELLS * h
    rcut = p3m.DEFAULT_RCUT_SIGMAS * sigma
    hidx, mass_mesh = p3m.heavy_split(pos_mass, p3m.DEFAULT_HEAVY_K)
    perm = torch.argsort(p3m.morton_keys(pos_mass, n_real), stable=True)
    ps = torch.cat([pos_mass[:, :3], mass_mesh[:, None]], 1)[perm].contiguous()
    c, f = p3m._tsc_cells(ps[:, :3], lo, h, grid)
    c4, fm = mc.mesh_operands(c, f, ps[:, 3])
    lo_b, hi_b = p3m._sorted_aabbs(ps, n_real, block)
    kth, neg, idx = p3m._select_neighbors(lo_b, hi_b, h, min(nbr_k, ps.shape[0] // block))
    mask = p3m.mutual_neighbor_mask(neg, idx, kth)
    return dict(ps=ps, lo=lo, h=h, sigma=sigma, rcut=rcut, c4=c4, fm=fm, nbr_idx=idx, mask=mask,
                hidx=hidx, lo_b=lo_b, hi_b=hi_b, perm=perm)


def _sr_agree(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, float]:
    """tests/test_p3m.py's short-range bound: ``|got - want| <= 2e-4 |want|
    + 3e-6 max|want|``; and the worst max-abs over scale."""
    scale = float(want.abs().max())
    ok = bool(((got - want).abs() <= 2e-4 * want.abs() + 3e-6 * scale).all())
    return ok, max_abs(got, want) / scale


# FP32 FLOP of a short_range (or short_range_bwd) pair's distance test,
# which every live-slot pair takes: the separation (3), r^2 (5) and the
# predicate's compares; the periodic minimum image adds its 6 selected adds.
# A pair within rcut takes the rest of its FLOP["short_range"] (47),
# FLOP["short_range_periodic"] (60), FLOP["short_range_bwd"] (100) or
# FLOP["short_range_bwd_periodic"] (180) and its MUFU results.
SR_TEST_FLOP = {"short_range": 12, "short_range_periodic": 18, "short_range_bwd": 12, "short_range_bwd_periodic": 18}


def rcut_shares(ps, nbr_idx, mask, rcut, block: int, box: float | None = None, tiles: int = 32) -> dict:
    """Counted on the card from ``short_range``'s inputs: the live-slot
    pairs (mask not 0), those with 0 < r^2 < rcut^2, and those the warps'
    votes send through the pair arithmetic (32 consecutive target rows
    against one source, all 32 if any is within rcut).  r^2 is the twin's
    f32 sum, not fused as the kernel's: a pair within an ulp of rcut may
    count the other way."""
    nb, k = nbr_idx.shape
    rows = ps[:, :3].reshape(nb, block, 3)
    rcut2 = (rcut * rcut).to(torch.float32)
    pairs = in_rcut = voted = 0
    for t0 in range(0, nb, tiles):
        t1 = min(nb, t0 + tiles)
        live_slot = mask[t0:t1] != 0
        src = rows[nbr_idx[t0:t1].long()]  # (T, k, b, 3)
        r2 = None
        for axis in (2, 1, 0):  # dx*dx + (dy*dy + dz*dz), as the kernel nests it
            d = src[:, :, None, :, axis] - rows[t0:t1, None, :, None, axis]  # (T, k, target, source)
            if box is not None:
                d = p3m.min_image(d, box)
            r2 = d * d if r2 is None else d * d + r2
        live = (r2 > 0) & (r2 < rcut2) & live_slot[:, :, None, None]
        pairs += int(live_slot.sum()) * block * block
        in_rcut += int(live.sum())
        voted += int(live.reshape(t1 - t0, k, block // 32, 32, block).any(dim=3).sum()) * 32
    return {"pairs": pairs, "in_rcut": in_rcut, "voted": voted}


def sr_bound(name: str, shares: dict, nbytes: float, mufu: int) -> dict:
    """``bound_ms`` and ``bound_by`` of ``short_range`` (or
    ``short_range_bwd``, by ``name``), counted from what this run's data
    needs: every live-slot pair's distance test, and the
    rest of the pair's FLOP and its ``mufu`` MUFU results for the pairs
    within rcut alone, against the FP32, MUFU and HBM rates.  Beside it,
    ``bound_all_pairs_ms``: the full arithmetic on every live-slot pair
    (the first design's work)."""
    test = SR_TEST_FLOP[name]
    flop = shares["pairs"] * test + shares["in_rcut"] * (FLOP[name] - test)
    ops_s = max(flop / FP32_FLOPS, shares["in_rcut"] * mufu / MUFU_RATE)
    bytes_s = nbytes / HBM_BYTES
    all_pairs = bound(name, shares["pairs"], nbytes, rsqrts=mufu * shares["pairs"])
    return {
        "bound_ms": max(ops_s, bytes_s) * 1e3,
        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
        "bound_all_pairs_ms": all_pairs["bound_ms"],
        "bound_all_pairs_by": all_pairs["bound_by"],
        "in_rcut_share": shares["in_rcut"] / shares["pairs"],
        "vote_share": shares["voted"] / shares["pairs"],
    }


def dense_slots(ps, nbr_idx, mask, rcut, block: int) -> int:
    """The live slots that the isolated ``short_range`` sweeps without its
    votes (``p3m._dense_slots``)."""
    return int(((p3m._dense_slots(ps, nbr_idx, block, rcut) != 0) & (mask != 0)).sum())


def _sr_vs_parent(tag: str, got, args: tuple, box: float | None = None, reps: int = 5) -> dict:
    """With ``--parent``: the parent's ``short_range`` on ``args`` (those of
    ``p3m.short_range_tiles``) equal to ``got`` bit for bit, and both timed
    in turns; {} without."""
    if not PARENT:
        return {}
    par = parent_short_range(*args, box=box)
    check(torch.equal(got, par), f"{tag}: short_range bit-equal to the parent's kernel "
                                 f"(max-abs {max_abs(got, par):.3e})")
    return vs_parent(f"{tag} short_range", lambda: p3m.short_range_tiles(*args, box=box),
                     lambda: parent_short_range(*args, box=box), reps=reps)


def planted_short_range_checks(dev, periodic: bool) -> None:
    """``short_range`` on ``pair_checks``' planted scenes against its twin
    (rtol 2e-4, atol 3e-6 of the max) and, with ``--parent``, the parent's
    kernel bit for bit."""
    for name, sc in pair_checks.short_range_scenes(periodic).items():
        ps = torch.from_numpy(sc["ps"]).to(dev)
        args = (ps, torch.from_numpy(sc["nbr_idx"]).to(dev), sc["eps2"], torch.tensor(sc["sigma"], device=dev),
                torch.tensor(sc["rcut"], device=dev), sc["block"], torch.from_numpy(sc["mask"]).to(dev))
        got = p3m.short_range_tiles(*args, box=sc["box"])
        want = p3m.short_range_tiles(*args, backend="jnp", box=sc["box"])
        torch.cuda.synchronize()
        ok, err = _sr_agree(got, want)
        tag = f"planted ({name})"
        check(ok and not got[:, 3].any(), f"{tag}: short_range vs plain rtol 2e-4, atol 3e-6 of max "
                                          f"(max-abs/max {err:.3e})")
        if PARENT:
            par = parent_short_range(*args, box=sc["box"])
            check(torch.equal(got, par), f"{tag}: short_range bit-equal to the parent's kernel")


def planted_short_range_bwd_checks(dev, periodic: bool) -> None:
    """``short_range_bwd`` on ``pair_checks``' planted scenes (their mutual
    masks; periodic also a warp astride the k' switch at u = 0.2) against
    its twin (``_bwd_agrees``) and, with ``--parent``, the parent's kernel
    bit for bit."""
    for name, sc in pair_checks.short_range_bwd_scenes(periodic).items():
        args = (torch.from_numpy(sc["ps"]).to(dev), torch.from_numpy(sc["g"]).to(dev),
                torch.from_numpy(sc["nbr_idx"]).to(dev), sc["eps2"], torch.tensor(sc["sigma"], device=dev),
                torch.tensor(sc["rcut"], device=dev), sc["block"], torch.from_numpy(sc["mask"]).to(dev))
        got = p3m.short_range_tiles_bwd(*args, box=sc["box"])
        want = p3m.short_range_tiles_bwd(*args, backend="jnp", box=sc["box"])
        torch.cuda.synchronize()
        tag = f"planted ({name})"
        _bwd_agrees(tag, got, want)
        _bwd_parent_equal(tag, got, args, sc["box"])


def _iroot(v: torch.Tensor, p: int) -> torch.Tensor:
    """The largest k with k^p <= v, elementwise (v >= 1)."""
    k = torch.floor(v.double() ** (1.0 / p)).long()
    k = torch.where((k + 1) ** p <= v, k + 1, k)
    return torch.where(k**p > v, k - 1, k)


def window_extents(e: torch.Tensor, cap: int) -> torch.Tensor:
    """csrc/mesh_deposit.cu's ``window_extents`` for each row of box extents
    ``e (nb, 3)``: the window of at most ``cap`` cells, as even as the box
    allows (the shortest axes keep their extent while below the even share)."""
    f, o = torch.sort(e, dim=1, stable=True)
    s3 = int(_iroot(torch.tensor(cap), 3))
    rest = cap // f[:, 0].clamp(min=1)
    s2 = _iroot(rest, 2)
    w = torch.stack([f[:, 0], f[:, 1], torch.minimum(f[:, 2], rest // f[:, 1].clamp(min=1))], 1)
    w = torch.where((f[:, 1] > s2)[:, None], torch.stack([f[:, 0], s2, s2], 1), w)
    w = torch.where((f[:, 0] > s3)[:, None], s3, w)
    return torch.empty_like(w).scatter_(1, o, w)


DEPOSIT_BOX_CAP = 4096  # csrc/mesh_deposit.cu's kBoxCap


def deposit_block_paths(c4: torch.Tensor, fm: torch.Tensor, grid: int, order: int,
                        periodic: bool) -> tuple[int, int, int]:
    """The blocks of ``mesh_deposit`` that take the whole box, a window of
    it and global atomics alone, computed in torch as csrc/mesh_deposit.cu
    decides: runs of 256 rows, each base cell unwrapped (periodic) to the
    image nearest the run's first row's; the box of the rows of nonzero
    mass plus the stencil if it holds at most ``DEPOSIT_BOX_CAP`` cells, else a
    window of :func:`window_extents` about the mean cell on the axes it
    cuts; global when fewer than 32 rows lie in the window."""
    run = 256
    n = c4.shape[0]
    nb = -(-n // run)
    c = torch.zeros((nb * run, 3), dtype=torch.long, device=c4.device)
    m = torch.zeros(nb * run, dtype=fm.dtype, device=fm.device)
    c[:n], m[:n] = c4[:, :3].long(), fm[:, 3]
    c, live = c.view(nb, run, 3), (m != 0).view(nb, run, 1)
    if periodic:
        d = c - c[:, :1]
        c = torch.where(d > grid // 2, c - grid, torch.where(d < -(grid // 2), c + grid, c))
    big = 1 << 40
    lo, hi = torch.where(live, c, big).amin(1), torch.where(live, c, -big).amax(1)
    count, sums = live.sum(1), torch.where(live, c, 0).sum(1)  # (nb, 1), (nb, 3)
    e = torch.where(count > 0, hi - lo + order, 0)
    cut = e.prod(1) > DEPOSIT_BOX_CAP
    path = torch.where(cut, 1, 0)
    w = window_extents(e, DEPOSIT_BOX_CAP)
    span = w - order + 1
    start = torch.minimum(torch.maximum(torch.div(sums, count.clamp(min=1), rounding_mode="trunc") - span // 2, lo),
                          hi - span + 1)
    win = torch.where(cut[:, None] & (w < e), start, lo)
    e = torch.where(cut[:, None], w, e)
    rel = c - win[:, None, :]
    inside = (live[..., 0] & ((rel >= 0) & (rel <= (e - order)[:, None, :])).all(2)).sum(1)
    path = torch.where((path == 1) & (inside < 32), 2, path)
    return tuple(int((path == k).sum()) for k in range(3))


def phase_mesh_checks(dev) -> None:
    """8a: the three mesh kernels against their plain twins on the card, on
    the clustered two-galaxy scene (n = 4,096) at N = 8,192 and 7,936,
    tiles 128 and 256, grids 32 and 128, both assignment orders, and
    ``short_range`` with every third row's second slot masked."""
    print("[8a mesh] short_range, mesh_deposit, mesh_gather vs plain twins, small shapes", flush=True)
    for n_pad, block in ((8192, 128), (8192, 256), (7936, 256)):
        pos_mass, _, n_real = _clustered(4096, n_pad, dev)
        for grid in (32, 128):
            x = _p3m_inputs(pos_mass, n_real, grid, block)
            tag = f"N={n_pad} block={block} grid={grid}"
            for order in (3, 2):
                c, f = (p3m._tsc_cells if order == 3 else pm._cic_cells)(x["ps"][:, :3], x["lo"], x["h"], grid)
                c4, fm = mc.mesh_operands(c, f, x["ps"][:, 3])
                rho, rho_p = mc.deposit(c4, fm, grid, order), mc.deposit_plain(c4, fm, grid, order)
                grids = p3m.solve_accel_long(rho_p, x["h"], EPS2, x["sigma"], order=order)
                e_rho, e_mass = rel_err(rho, rho_p), abs(float(rho.sum() / rho_p.sum()) - 1.0)
                check(e_rho < 1e-5 and e_mass < 1e-6,
                      f"{tag} order {order}: mesh_deposit vs plain max-abs/max {e_rho:.3e} < 1e-5, "
                      f"total mass {e_mass:.3e} < 1e-6")
                _gather_agrees(tag, grids, c4, fm, grid, order, False)
            mask = x["mask"].clone()
            mask[::3, 1] = 0.0
            args = (x["ps"], x["nbr_idx"], EPS2, x["sigma"], x["rcut"], block)
            for what, m in (("mutual mask", x["mask"]), ("mask with slots zeroed", mask)):
                got = p3m.short_range_tiles(*args, m)
                want = p3m.short_range_tiles(*args, m, backend="jnp")
                torch.cuda.synchronize()
                ok, err = _sr_agree(got, want)
                check(ok and not got[:, 3].any(),
                      f"{tag}: short_range vs plain ({what}, {int((m == 0).sum())} slots off) "
                      f"rtol 2e-4, atol 3e-6 of max (max-abs/max {err:.3e})")
                if PARENT:
                    check(torch.equal(got, parent_short_range(*args, m)),
                          f"{tag}: short_range ({what}) bit-equal to the parent's kernel")
    planted_short_range_checks(dev, periodic=False)
    _deposit_adversarial_checks(dev, periodic=False)
    _gather_box_checks(dev, periodic=False)


def _momentum(sim: Simulation) -> torch.Tensor:
    p = sim.state.pos_mass.double()
    return (p[:, 3:4] * sim.state.vel[:, :3].double()).sum(dim=0)


def _mesh_run(sim: Simulation, tag: str, chunks: int, chunk: int, warm: int = 30) -> float:
    """``warm`` untimed steps, over which the momentum error is checked
    against 1e-5 of sum |m v| (of the start; of the state after them for a
    cold start, sum |m v| = 0), then ``chunks`` timed chunks of ``chunk``
    steps.  Prints ms/step (the median chunk) and the momentum error over
    all steps; returns the ms/step."""

    def abs_momentum():
        return float((sim.state.pos_mass[:, 3:4].double() * sim.state.vel[:, :3].double()).abs().sum())

    p0 = _momentum(sim)
    pscale = abs_momentum()
    warm_s = _timed_chunks(sim, 1, warm)[0]
    pscale = pscale or abs_momentum()
    mom = float((_momentum(sim) - p0).abs().max()) / pscale
    times = _timed_chunks(sim, chunks, chunk)
    mom_all = float((_momentum(sim) - p0).abs().max()) / pscale
    med = statistics.median(times)
    ms = med / chunk * 1e3
    gints = sim.pair_interactions_per_step * chunk / med / 1e9
    finite = bool(torch.isfinite(sim.state.pos_mass).all() and torch.isfinite(sim.state.vel).all())
    print(f"{tag}: median of {chunks} chunks of {chunk} steps {med:.4f} s = {ms:.4f} ms/step, direct-equivalent "
          f"{gints:.2f} G-int/s; warm {warm} steps {warm_s:.4f} s, timed {[round(t, 4) for t in times]}; "
          f"momentum err {mom:.3e} after {warm} steps, {mom_all:.3e} after {warm + chunks * chunk}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(finite and sim.state.pos_mass.shape == (sim.n_pad, 4), f"{tag}: finite state of shape (n_pad, 4)")
    check(mom <= 1e-5, f"{tag}: momentum error over the first {warm} steps {mom:.3e} <= 1e-5")
    return ms


MESH_SIMS: dict[str, Simulation] = {}  # 8b's and 8d's simulations, for the checks after their windows


def phase_p3m(dev):
    """8b: the P3M path at full width (benchmarks/p3m_bench.py's
    configuration, grid 128, k = 32, tile 256, on two-galaxy with 2^20 disk
    bodies a galaxy: 8,193 tiles, the two-level selection), 30 warm steps
    and 2 timed chunks of 10."""
    torch.cuda.reset_peak_memory_stats()
    cfg = SimConfig(method="p3m", pm_grid=128, p3m_nbr_k=32)
    sim = Simulation.from_preset("two-galaxy", cfg, n=P3M_N, device=dev)
    nb = sim.n_pad // p3m.DEFAULT_BLOCK
    check(nb == 8193 and nb > p3m._FLAT_MAX_TILES,
          f"8b: n_real {sim.n_real}, n_pad {sim.n_pad}, {nb} tiles > {p3m._FLAT_MAX_TILES}: two-level selection")
    MAIN["phase 8b"] = _mesh_run(sim, f"[8b p3m] two-galaxy N={sim.n_real} (n_pad {sim.n_pad}) grid 128 k 32",
                                 chunks=2, chunk=10)
    MESH_SIMS["p3m"] = sim
    return [("p3m step at 2M", lambda: sim.run(1, chunk=1))]


def phase_pm(dev):
    """8d: PM at two-galaxy N = 2,097,152, grid 128: 30 warm steps and 5
    timed chunks of 50 (a step takes a few ms, so shorter chunks time the
    host's jitter)."""
    torch.cuda.reset_peak_memory_stats()
    sim = Simulation.from_preset("two-galaxy", SimConfig(method="pm", pm_grid=128), n=PM_N, device=dev)
    _mesh_run(sim, f"[8d pm] two-galaxy N={sim.n_real} (n_pad {sim.n_pad}) grid 128", chunks=5, chunk=50)
    MESH_SIMS["pm"] = sim
    return [("pm step at 2M", lambda: sim.run(1, chunk=1))]


def phase_p3m_probe(dev) -> None:
    """8c: p3m_bench.accuracy_probe's scene (two-galaxy n = 16,384, seed 1,
    grid 128, k = 32) against ``force_exact``, then the README's run through
    the CLI: two-galaxy, 200 steps, energy drift <= 1e-3, momentum <= 1e-5."""
    pos_mass, _, n_real = _clustered(16384, pad_count(16384, PAD_GRANULE), dev, seed=1)
    ref = cf.force_exact(pos_mass, pos_mass, G, EPS2)[:n_real, :3]
    got = p3m.accel_p3m(pos_mass, G, grid=128, n_real=n_real, nbr_k=32)[:n_real, :3]
    rel = (torch.linalg.norm(got - ref, dim=1) / torch.linalg.norm(ref, dim=1).clamp(min=1e-20)).cpu().numpy()
    ov = p3m.p3m_neighbor_overflow(pos_mass, grid=128, n_real=n_real, nbr_k=32)
    med, p99 = float(np.median(rel)), float(np.percentile(rel, 99))
    check(med < 2e-3 and p99 < 1e-2,
          f"[8c p3m accuracy] two-galaxy N={n_real} grid 128 k 32 vs force_exact: median {med:.3e} < 2e-3, "
          f"p99 {p99:.3e} < 1e-2 (max {rel.max():.3e}, tile overflow {ov})")
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["run", "--device", dev.type, "--method", "p3m", "--preset", "two-galaxy", "--steps", "200",
                "--log-every", "50", "--diagnostics", "--outdir", tmp]
        print(f"[8c p3m run] cli {' '.join(argv)}", flush=True)
        d0 = Simulation.from_preset("two-galaxy", SimConfig(method="p3m"), device=dev).diagnostics()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        run_s = time.perf_counter() - t0
        sim = Simulation.load(str(pathlib.Path(tmp) / "final.npz"), device=dev)
        drift, mom, finite = _conservation(sim, d0, sim.diagnostics())
    check(rc == 0 and finite and sim.step_count == 200 and sim.config.method == "p3m",
          f"p3m run rc {rc} in {run_s:.3f} s, step {sim.step_count}, method {sim.config.method}, finite")
    check(drift <= 1e-3 and mom <= 1e-5, f"p3m run: energy drift {drift:.3e} <= 1e-3, momentum error {mom:.3e} <= 1e-5")


def phase_mesh_crosscheck(dev) -> None:
    """8e: at N = 8,192 (two-galaxy n = 4,096) the kernel route of ``pm`` and
    ``p3m`` against ``backend="jnp"`` on the card: the accelerations and a
    5-step rollout, rtol 1e-4 and atol 1e-5 of the scale."""
    from nbody3d_tpu_torch.ops.step import make_mesh_accel_fn

    pos_mass, vel, n_real = _clustered(4096, 8192, dev)
    for method in ("p3m", "pm"):
        cfg = SimConfig(method=method)
        acc_k = make_mesh_accel_fn(cfg, n_real, "kernels")(pos_mass, G)
        acc_p = make_mesh_accel_fn(cfg, n_real, "plain")(pos_mass, G)
        states = {}
        for route, c in (("kernels", cfg), ("jnp", cfg.replace(backend="jnp"))):
            step = make_step_fn(c, 8192, n_real, dev)
            s = SimState(pos_mass.clone(), vel.clone(), torch.zeros_like(pos_mass), 0)
            for _ in range(5):
                s = step(s, DT_MAIN, G)
            states[route] = s
        torch.cuda.synchronize()
        for what, a, b in (("accel", acc_k, acc_p),
                           ("5-step positions", states["kernels"].pos_mass, states["jnp"].pos_mass),
                           ("5-step velocities", states["kernels"].vel, states["jnp"].vel)):
            a, b = a[:n_real, :3], b[:n_real, :3]
            scale = float(b.abs().max())
            excess = float(((a - b).abs() - 1e-4 * b.abs()).max())
            check(excess <= 1e-5 * scale, f"[8e mesh check] N=8192 {method} kernel route vs jnp route, {what}: "
                  f"worst |diff| - 1e-4|ref| = {excess:.3e} <= {1e-5 * scale:.3e}")


def _stage_ms(x: dict, n_real: int, grid: int, block: int) -> dict[str, float]:
    """Device ms of each stage of one P3M force evaluation on ``x``."""
    ps, h, sigma = x["ps"], x["h"], x["sigma"]
    rho = mc.deposit(x["c4"], x["fm"], grid, 3)
    grids = p3m.solve_accel_long(rho, h, EPS2, sigma)

    def select():
        kth, neg, idx = p3m._select_neighbors(x["lo_b"], x["hi_b"], h, 32)
        return p3m.mutual_neighbor_mask(neg, idx, kth)

    stages = {
        "Morton keys + sort": lambda: torch.argsort(p3m.morton_keys(ps, n_real), stable=True),
        "heavy split": lambda: p3m.heavy_split(ps, p3m.DEFAULT_HEAVY_K),
        "TSC cells": lambda: mc.mesh_operands(*p3m._tsc_cells(ps[:, :3], x["lo"], h, grid), ps[:, 3]),
        "mesh_deposit": lambda: mc.deposit(x["c4"], x["fm"], grid, 3),
        "FFT solve + kernel grids (solve_accel_long)": lambda: p3m.solve_accel_long(rho, h, EPS2, sigma),
        "mesh_gather": lambda: mc.gather(grids, x["c4"], x["fm"], grid, 3),
        "tile AABBs": lambda: p3m._sorted_aabbs(ps, n_real, block),
        "neighbour selection + mutual mask": lambda: select(),
        "short_range": lambda: p3m.short_range_tiles(ps, x["nbr_idx"], EPS2, sigma, x["rcut"], block, x["mask"]),
        "heavy_direct": lambda: p3m.heavy_direct(ps, x["hidx"], EPS2),
    }
    return {name: cuda_ms(fn, reps=3) for name, fn in stages.items()}


def _deposit_agrees(tag: str, c4, fm, grid: int, order: int, rho, rho_p, periodic: bool = False,
                    seam: bool = False):
    """Holds a full-size deposit (kernel ``rho`` and twin ``rho_p``) against
    the same f32 terms summed in f64, and returns the terms ``(idx, val)``.

    At 2M a core cell takes about 1e5 f32 atomic adds in no fixed order, in
    the kernel and in the twin's index_add_ alike, so each cell is held to
    the bound of any order of f32 summation, (adds into the cell) x 2^-24 x
    the cell's sum (every term is >= 0), and the total mass to the sum of
    those bounds.  That bound is loose where a cell takes many adds, so a
    second deposit on the same cells gives every body exact terms (TSC
    f = 1/2: weights 0, 1/2, 1/2 an axis; CIC f = 0: 1, 0; mass 1), whose
    sums are exact in any order: the kernel must match them bit for bit,
    which a lost or repeated atomic add would break.  ``periodic``: the
    stencil wraps, and the exact terms take f = 1/2 at both orders (CIC:
    1/2, 1/2 an axis), so that a body in the far corner, whose stencil
    wraps, writes the first and the last cell; with ``seam`` (a scene with
    such a body) both must be written."""
    idx, val, rho64, allowed = f32_sum_bounds(c4, fm, grid, order, periodic)
    worst = {name: f32_sum_excess(r, rho64, allowed) for name, r in (("kernel", rho), ("twin", rho_p))}
    check(all(w[0] <= 1.0 for w in worst.values()),
          f"{tag}: mesh_deposit and twin vs f64 sums of the same terms, each cell within its f32 summation "
          f"bound (worst error / bound: kernel {worst['kernel'][0]:.3e}, twin {worst['twin'][0]:.3e}; max-abs/max "
          f"{rel_err(rho.view(-1).double(), rho64):.3e}, twin {rel_err(rho_p.view(-1).double(), rho64):.3e}; "
          f"up to {int(torch.bincount(idx).max())} adds a cell)")
    check(all(w[1] <= 1.0 for w in worst.values()),
          f"{tag}: total mass vs f64, error / the summed cell bounds kernel {worst['kernel'][1]:.3e}, twin "
          f"{worst['twin'][1]:.3e} <= 1 (the bound is {float(allowed.sum() / rho64.sum()):.3e} of the mass)")
    exact = fm.clone()
    exact[:, :3] = 0.5 if order == 3 or periodic else 0.0
    exact[:, 3] = 1.0
    got = mc.deposit(c4, exact, grid, order, periodic).view(-1).double()
    want = mc.deposit_plain(c4, exact.double(), grid, order, periodic).view(-1)
    cells = f", first cell {float(got[0]):.3f}, last cell {float(got[-1]):.3f}" if periodic else ""
    check(torch.equal(got, want) and float(got.sum()) == fm.shape[0] and (not seam or got[0] * got[-1] > 0),
          f"{tag}: mesh_deposit with exact terms (mass 1 a body) equal to their f64 sums in every cell, total "
          f"{float(got.sum()):.1f} = {fm.shape[0]} bodies (worst cell |diff| {float((got - want).abs().max()):.3e})"
          + cells)
    return idx, val


def _deposit_adversarial_checks(dev, periodic: bool) -> None:
    """8a's (isolated) or 12a's (periodic) :func:`deposit_adversarial`
    scenes at grids 32 and 128, TSC and CIC: the kernel against its twin as
    :func:`_deposit_agrees` holds it (the exact-term deposit too), and its
    count of blocks a path equal to :func:`deposit_block_paths`'.  Some
    blocks must take each of the three paths."""
    tally = {}
    for name, (pm_np, n_real, per) in deposit_adversarial().items():
        if per != periodic:
            continue
        for grid in (32, 128):
            for order in (3, 2):
                c4, fm = deposit_operands(pm_np, n_real, per, grid, order, dev, sort=name != "shuffled")
                rho_p = mc.deposit_plain(c4, fm, grid, order, per)
                paths = torch.zeros(3, dtype=torch.int32, device=dev)
                rho = mc.deposit(c4, fm, grid, order, per, block_paths=paths)
                got, want = tuple(paths.tolist()), deposit_block_paths(c4, fm, grid, order, per)
                tag = f"{name} ({'unsorted' if name == 'shuffled' else 'Morton'}) grid {grid} order {order}"
                check(got == want, f"{tag}: blocks on the whole box / a window / global atomics {got}, as "
                                   f"computed in torch {want}")
                _deposit_agrees(tag, c4, fm, grid, order, rho, rho_p, periodic=per, seam=name == "seam, periodic")
                tally[name] = [a + b for a, b in zip(tally.get(name, (0, 0, 0)), got)]
    check(all(sum(t[k] for t in tally.values()) > 0 for k in range(3)),
          f"{'periodic' if periodic else 'isolated'} adversarial deposits: blocks took each path (whole box, "
          f"window, global over both grids and orders: {tally})")


def _gather_agrees(tag: str, grids, c4, fm, grid: int, order: int, periodic: bool) -> list[int]:
    """``mesh_gather``'s two kernels (``sorted_rows`` True: the runs' boxes;
    False: the loop alone) against the twin (1e-5 of the max, w lane 0) and
    bit-equal to each other, their runs a path (box, global) equal to
    :func:`gather_checks.block_paths`' mirror of the decisions, and with
    ``--parent`` bit-equal to the parent's kernel.  Returns the box
    kernel's runs a path."""
    acc_p = mc.gather_plain(grids, c4, fm, grid, order, periodic)
    outs, got = [], {}
    for sorted_rows in (True, False):
        paths = torch.zeros(2, dtype=torch.int32, device=fm.device)
        outs.append(mc.gather(grids, c4, fm, grid, order, periodic, sorted_rows, block_paths=paths))
        got[sorted_rows] = paths.tolist()
    e_acc = rel_err(outs[0], acc_p)
    want = {k: gather_checks.block_paths(c4, grid, order, periodic, k) for k in (True, False)}
    check(e_acc < 1e-5 and not outs[0][:, 3].any() and torch.equal(outs[0], outs[1]) and got == want,
          f"{tag} order {order}: {'periodic ' if periodic else ''}mesh_gather vs plain max-abs/max {e_acc:.3e} < "
          f"1e-5, its two kernels bit-equal; runs on the box / global {got[True]} (sorted rows), {got[False]} "
          f"(unsorted), as the mirror's")
    _parent_equal(f"{tag} order {order}: mesh_gather", outs[0], parent_gather, grids, c4, fm, grid, order, periodic)
    return got[True]


def _gather_box_checks(dev, periodic: bool) -> None:
    """8a's (isolated: :func:`deposit_adversarial`'s isolated scenes) or 12a's
    (periodic: :func:`gather_checks.seam_scenes`) gathers at grids 16, 32 and
    128, TSC and CIC, through :func:`_gather_agrees` on random grids.  Some
    runs of the box kernel must take each path."""
    if periodic:
        scenes = {k: (pm_np, n_real, sort) for k, (pm_np, n_real, sort) in gather_checks.seam_scenes().items()}
    else:
        scenes = {k: (pm_np, n_real, k != "shuffled") for k, (pm_np, n_real, per) in deposit_adversarial().items()
                  if not per}
    tally = [0, 0]
    gen = torch.Generator(device=dev).manual_seed(17)
    for name, (pm_np, n_real, sort) in scenes.items():
        for grid in (16, 32, 128):
            grids = torch.randn(3, grid**3, device=dev, generator=gen)
            for order in (3, 2):
                c4, fm = deposit_operands(pm_np, n_real, periodic, grid, order, dev, sort=sort)
                got = _gather_agrees(f"{name} ({'Morton' if sort else 'unsorted'}) grid {grid}", grids, c4, fm,
                                     grid, order, periodic)
                tally = [a + b for a, b in zip(tally, got)]
    check(min(tally) > 0, f"{'periodic seam' if periodic else 'isolated adversarial'} gathers: blocks took each "
                          f"path (box, global: {tally})")


def _gather_large_grid_checks(dev, grid: int = 1290) -> None:
    """The gather at the largest grid the wrapper takes, where the second
    and third grids start past 2^31 floats: :func:`gather_checks.seam_scenes`'
    tight corner and far corner scenes, periodic and isolated, TSC and CIC,
    through :func:`_gather_agrees` on random grids (3 x 1,290^3 floats,
    25.8 GB).  Some runs must take the box."""
    scenes = {k: v for k, v in gather_checks.seam_scenes().items() if k in ("tight corner", "far corner and padding")}
    grids = torch.randn(3, grid**3, device=dev, generator=torch.Generator(device=dev).manual_seed(18))
    for periodic in (True, False):
        tally = [0, 0]
        for name, (pm_np, n_real, sort) in scenes.items():
            for order in (3, 2):
                c4, fm = deposit_operands(pm_np, n_real, periodic, grid, order, dev, sort=sort)
                got = _gather_agrees(f"{name} grid {grid} ({'periodic' if periodic else 'isolated'})", grids, c4, fm,
                                     grid, order, periodic)
                tally = [a + b for a, b in zip(tally, got)]
        check(tally[0] > 0, f"{'periodic' if periodic else 'isolated'} gathers at grid {grid}: runs took the box "
                            f"(box, global: {tally})")
    del grids
    torch.cuda.empty_cache()


def _gather_row(tag: str, grids, c4, fm, grid: int, order: int, periodic: bool, sorted_rows: bool) -> dict:
    """At a full-size shape, the kernel its path takes (``sorted_rows``): its
    runs a path (the mirror's too, as :func:`_gather_agrees`), and with
    ``--parent`` bit-equal to the parent's kernel and both timed in turns;
    the other kernel's time beside it."""
    paths = torch.zeros(2, dtype=torch.int32, device=fm.device)
    got = mc.gather(grids, c4, fm, grid, order, periodic, sorted_rows, block_paths=paths)
    want = gather_checks.block_paths(c4, grid, order, periodic, sorted_rows)
    check(paths.tolist() == want, f"{tag}: mesh_gather's runs on the box / global {paths.tolist()}, as the "
                                  f"mirror's {want}")
    out = {"block_paths": paths.tolist()}
    other = cuda_ms(lambda: mc.gather(grids, c4, fm, grid, order, periodic, not sorted_rows), reps=20)
    if PARENT:
        _parent_equal(f"{tag}: mesh_gather", got, parent_gather, grids, c4, fm, grid, order, periodic, sorted_rows)
        out.update(vs_parent(f"{tag} mesh_gather", lambda: mc.gather(grids, c4, fm, grid, order, periodic,
                                                                     sorted_rows),
                             lambda: parent_gather(grids, c4, fm, grid, order, periodic, sorted_rows)))
    print(f"  mesh_gather {tag}: runs on the box / global {out['block_paths']}; the "
          f"{'loop alone' if sorted_rows else 'box'} kernel here {other:.4f} ms", flush=True)
    return out


def _p3m_checks_2m(sim: Simulation, samples: int = 4096, chunk: int = 32) -> None:
    """8b's selection and force on the state it leaves, at full width.

    The card's neighbour lists, distances and mutual mask must equal the
    host CPU's from the same tile boxes (the CPU route is the one
    tests/test_torch_p3m.py holds bit-equal to the JAX package, supers of
    one tile included), and the mask's pair set must be symmetric.

    At k = 32 every tile of this shape drops source tiles within rcut, and
    the force then departs from the direct sum by the short range of the
    pairs left out: the JAX package's configuration does the same
    (tests/test_torch_p3m.py::test_accel_p3m_overflow_matches_jax, where
    past p3m_bench's probe size its p99 leaves the contract, and the
    port's with it).  So the contract, median < 2e-3 and p99 < 1e-2
    (tests/test_p3m.py at grid 128), holds the force of ``samples``
    sampled bodies (heavy ones aside) against what the selection asks for:
    ``force_exact`` over all bodies less the short-range part of every pair
    the selection leaves out or the cut drops.  The error against the
    direct sum itself, the left-out share and the tile overflow are
    printed."""
    from nbody3d_tpu_torch.ops.step import make_mesh_accel_fn

    pos_mass, n_real, cfg = sim.state.pos_mass, sim.n_real, sim.config
    n, block, dev = pos_mass.shape[0], p3m.DEFAULT_BLOCK, pos_mass.device
    x = _p3m_inputs(pos_mass, n_real, cfg.pm_grid, block, cfg.p3m_nbr_k)
    nb = n // block
    t0 = time.perf_counter()
    kth, neg, idx = p3m._select_neighbors(x["lo_b"].cpu(), x["hi_b"].cpu(), x["h"].cpu(), cfg.p3m_nbr_k)
    cpu_s = time.perf_counter() - t0
    mask = p3m.mutual_neighbor_mask(neg, idx, kth)
    same = torch.equal(idx, x["nbr_idx"].cpu()) and torch.equal(mask, x["mask"].cpu())
    live = x["mask"] > 0
    cover = torch.zeros((nb, nb), dtype=torch.bool, device=dev)  # target tile x source tile kept
    cover[live.nonzero()[:, 0], x["nbr_idx"][live]] = True
    one_sided = int((cover & ~cover.T).sum())
    check(same and one_sided == 0,
          f"[8b p3m selection] {nb} tiles, {'two-level' if nb > p3m._FLAT_MAX_TILES else 'flat'}: card's lists and mask equal to the host CPU's "
          f"({cpu_s:.1f} s there): {same}; {int(live.sum())} live slots, {one_sided} one-sided tile pairs")

    inv = torch.empty_like(x["perm"])
    inv[x["perm"]] = torch.arange(n, device=dev)
    tile = inv // block  # each body's tile in the sorted order
    mass_mesh = pos_mass[:, 3].index_fill(0, x["hidx"], 0.0)
    light = torch.ones(n_real, dtype=torch.bool, device=dev)
    light[x["hidx"][x["hidx"] < n_real]] = False
    pick = np.random.default_rng(0).choice(light.nonzero()[:, 0].cpu().numpy(), samples, replace=False)
    rows = torch.from_numpy(pick).to(dev)
    direct = cf.force_exact(pos_mass[rows].contiguous(), pos_mass, cfg.G, cfg.eps2)[:, :3].double()
    left_out = torch.zeros((samples, 3), dtype=torch.float64, device=dev)
    rcut2 = x["rcut"] * x["rcut"]
    for c0 in range(0, samples, chunk):
        r = rows[c0 : c0 + chunk]
        d = pos_mass[None, :, :3] - pos_mass[r, None, :3]  # (chunk, N, 3), toward the source
        r2 = torch.sum(d * d, dim=-1)
        kept = cover[tile[r]][:, tile] & (r2 < rcut2)
        w = p3m.k_short(r2, cfg.eps2, x["sigma"]) * mass_mesh * ~kept
        left_out[c0 : c0 + chunk] = torch.sum(w[..., None] * d, dim=1, dtype=torch.float64)
    want = direct - cfg.G * left_out
    got = make_mesh_accel_fn(cfg, n_real, "kernels")(pos_mass, cfg.G)[rows, :3].double()

    def rel(a, b):
        return (torch.linalg.norm(a - b, dim=1) / torch.linalg.norm(b, dim=1).clamp(min=1e-300)).cpu().numpy()

    e_alg, e_dir, share = rel(got, want), rel(got, direct), rel(want, direct)
    ov = p3m.p3m_neighbor_overflow(pos_mass, grid=cfg.pm_grid, n_real=n_real, nbr_k=cfg.p3m_nbr_k)
    med, p99 = float(np.median(e_alg)), float(np.percentile(e_alg, 99))
    print(f"[8b p3m accuracy] N={n_real}, {samples} sampled bodies: against force_exact median "
          f"{np.median(e_dir):.3e}, p99 {np.percentile(e_dir, 99):.3e}, max {e_dir.max():.3e}; the short range "
          f"left out is a median {np.median(share):.3e} (p99 {np.percentile(share, 99):.3e}) of the force; "
          f"tile overflow {ov} of {nb}", flush=True)
    check(med < 2e-3 and p99 < 1e-2,
          f"[8b p3m accuracy] N={n_real}, {samples} sampled bodies against force_exact less the left-out "
          f"short range: median {med:.3e} < 2e-3, p99 {p99:.3e} < 1e-2 (max {e_alg.max():.3e})")


def _two_level_grad(sim: Simulation) -> None:
    """On 8b's state (8,193 tiles: the two-level selection, which 9b's 8,192
    do not reach): ``short_range_bwd`` against its twin on the card at that
    shape, for a random cotangent, and a 2-step rollout gradient by v0
    through ``make_step_fn`` with the mesh path's twins raising, its ms/step
    and peak memory."""
    pos_mass, n_real, cfg = sim.state.pos_mass, sim.n_real, sim.config
    n, block, dev = pos_mass.shape[0], p3m.DEFAULT_BLOCK, pos_mass.device
    x = _p3m_inputs(pos_mass, n_real, cfg.pm_grid, block, cfg.p3m_nbr_k)
    nb, k = x["nbr_idx"].shape
    tag = f"[8b two-level grad] two-galaxy N={n_real} (n_pad {n}), {nb} tiles, k {k}"
    check(nb > p3m._FLAT_MAX_TILES, f"{tag}: {nb} tiles > {p3m._FLAT_MAX_TILES}, the two-level selection")
    args = (x["ps"], _random_cotangent(n, dev, 11), x["nbr_idx"], EPS2, x["sigma"], x["rcut"], block, x["mask"])
    got = p3m.short_range_tiles_bwd(*args)
    want = None

    def run_plain():
        nonlocal want
        want = p3m.short_range_tiles_bwd(*args, backend="jnp")

    plain_ms = host_ms(run_plain)
    _bwd_agrees(tag, got, want)
    ms = cuda_ms(lambda: p3m.short_range_tiles_bwd(*args), reps=3)
    live = int((x["mask"] != 0).sum())
    shares = rcut_shares(x["ps"], x["nbr_idx"], x["mask"], x["rcut"], block)
    b = sr_bound("short_range_bwd", shares, 52 * n + 8 * nb * k, SR_MUFU)
    print(f"  {tag}: short_range_bwd kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (one run, host clock), "
          f"{live} live slots, {dense_slots(x['ps'], x['nbr_idx'], x['mask'], x['rcut'], block)} without votes; "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})" + _extras(b), flush=True)
    _bwd_vs_parent(f"{tag} (8b two-level gradient)", got, args)
    del got, want, args, x
    torch.cuda.reset_peak_memory_stats()
    step = make_step_fn(cfg, n, n_real, dev)
    with no_twins():
        t_f, t_g, g, _ = _rollout_times(step, pos_mass, sim.state.vel, 2,
                                        lambda s: (s.pos_mass[:n_real, :3] ** 2).sum() / n_real)
    print(f"  {tag}: 2-step rollout, forward {t_f:.4f} ms/step, gradient {t_g:.4f} ms/step, ratio {t_g / t_f:.3f}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, f"{tag}: 2-step gradient finite and nonzero")


def _grid_sample_call(grids: torch.Tensor, c4: torch.Tensor, fm: torch.Tensor, grid: int):
    """The CIC gather as one ``torch.nn.functional.grid_sample`` call
    (trilinear, ``align_corners=True``) on the ``(1, 3, G, G, G)`` grids: a
    particle's fractional cell index ``c + f`` in [0, G-1] maps onto
    [-1, 1], in (z, y, x) order since the last grid axis is z.  The
    coordinates are made outside the call."""
    vol = grids.view(1, 3, grid, grid, grid)
    coords = ((c4[:, :3].float() + fm[:, :3]).flip(1) * (2.0 / (grid - 1)) - 1.0).view(1, 1, 1, -1, 3)
    return lambda: torch.nn.functional.grid_sample(vol, coords, mode="bilinear", padding_mode="zeros",
                                                   align_corners=True)


def _deposit_row(tag: str, c4, fm, grid: int, order: int, periodic: bool = False) -> dict:
    """``mesh_deposit`` at a full-size shape: the kernel (default knobs)
    against its twin as :func:`_deposit_agrees` holds it, then in one go
    the kernel's time, the twin's (host clock, one run), ``index_add_``
    over the pre-expanded (cell, weight) pairs with the grid's zero fill
    (the library call of the same function), the bound and the blocks a
    path."""
    dev, n = fm.device, fm.shape[0]
    paths = torch.zeros(3, dtype=torch.int32, device=dev)
    rho = mc.deposit(c4, fm, grid, order, periodic, block_paths=paths)
    rho_p = None

    def run_plain():
        nonlocal rho_p
        rho_p = mc.deposit_plain(c4, fm, grid, order, periodic)

    plain_ms = host_ms(run_plain)
    idx, val = _deposit_agrees(tag, c4, fm, grid, order, rho, rho_p, periodic=periodic)
    lib_call = lambda: torch.zeros(grid**3, device=dev).index_add_(0, idx, val)  # noqa: E731
    *_, rho64, allowed = f32_sum_bounds(c4, fm, grid, order, periodic)
    e_lib = f32_sum_excess(lib_call(), rho64, allowed)
    check(max(e_lib) <= 1.0, f"{tag}: index_add_ over the pairs vs f64 sums, each cell and the total within their "
                             f"f32 summation bounds (worst error / bound {e_lib[0]:.3e}, total {e_lib[1]:.3e})")
    del rho64, allowed
    ms = cuda_ms(lambda: mc.deposit(c4, fm, grid, order, periodic), reps=20)
    library_ms = cuda_ms(lib_call, reps=20)
    del idx, val
    parent = {}
    if PARENT:
        *_, rho64, allowed = f32_sum_bounds(c4, fm, grid, order, periodic)
        e_par = f32_sum_excess(parent_deposit(c4, fm, grid, order, periodic), rho64, allowed)
        check(max(e_par) <= 1.0, f"{tag}: the parent's kernel within the f32 summation bounds ({e_par[0]:.3e})")
        del rho64, allowed
        parent = vs_parent(tag, lambda: mc.deposit(c4, fm, grid, order, periodic),
                           lambda: parent_deposit(c4, fm, grid, order, periodic))
    kind = ("TSC" if order == 3 else "CIC") + (", torus" if periodic else "")
    r = {
        "max_abs_err": max_abs(rho, rho_p), "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "shape": f"({n}, 4) x 2 -> {grid}^3, {kind}",
        "block_paths": paths.tolist(),
        "note": f"blocks (whole box, window, global) {paths.tolist()}; library: index_add_ over the "
                f"{order ** 3}N pre-expanded (cell, weight) pairs, with the grid's zero fill; plain: one run, "
                f"host clock",
        **parent,
        **bound("mesh_deposit", n, 32 * n + 4 * grid**3),
    }
    print(f"  mesh_deposit {tag}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library {library_ms:.4f} ms  "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  max-abs err {r['max_abs_err']:.3e}  [{r['note']}]",
          flush=True)
    return r


def _pm_kernels_2m(sim: Simulation) -> dict:
    """8d's CIC kernels at its shape and data (the state after 8d's run)
    against their twins: the deposit as :func:`_deposit_row` (its entry
    ``cic_8d``), the gather at 1e-5 of the max; then the gather beside
    ``grid_sample``, the library call of the same function (mesh_gather's
    ``library_ms``).  Returns ``(deposit row, gather's library fields)``."""
    grid = sim.config.pm_grid
    pos_mass = sim.state.pos_mass
    lo, h = pm._box(pos_mass[: sim.n_real, :3], grid)
    c4, fm = mc.mesh_operands(*pm._cic_cells(pos_mass[:, :3], lo, h, grid), pos_mass[:, 3])
    dep = _deposit_row(f"2M PM (CIC, N={fm.shape[0]})", c4, fm, grid, 2)
    grids = pm.force_grids(pm.solve_potential(mc.deposit_plain(c4, fm, grid, 2), h, sim.config.eps2), h)
    acc = mc.gather(grids, c4, fm, grid, 2, sorted_rows=False)
    e_acc = rel_err(acc, mc.gather_plain(grids, c4, fm, grid, 2))
    check(e_acc < 1e-5, f"2M PM (CIC, N={fm.shape[0]}): mesh_gather vs plain max-abs/max {e_acc:.3e} < 1e-5")
    lib_call = _grid_sample_call(grids, c4, fm, grid)
    e_lib = rel_err(lib_call()[0, :, 0, 0, :].T, acc[:, :3])
    check(e_lib < 1e-4, f"2M PM (CIC): grid_sample vs mesh_gather max-abs/max {e_lib:.3e} < 1e-4 (the same function)")
    kernel_ms = cuda_ms(lambda: mc.gather(grids, c4, fm, grid, 2, sorted_rows=False), reps=20)
    lib_ms = cuda_ms(lib_call, reps=20)
    print(f"  mesh_gather CIC at 8d's shape ({fm.shape[0]} particles, {grid}^3): kernel {kernel_ms:.4f} ms, "
          f"grid_sample {lib_ms:.4f} ms", flush=True)
    cic = {"ms": kernel_ms, **_gather_row(f"2M PM (CIC, N={fm.shape[0]})", grids, c4, fm, grid, 2, False, False)}
    return dep, {"library_ms": lib_ms, "cic_8d": cic,
                 "library_note": f"torch.nn.functional.grid_sample (trilinear, align_corners=True) at 8d's CIC "
                                 f"shape, {fm.shape[0]} particles, {grid}^3; mesh_gather there {kernel_ms:.4f} ms"}


def phase_mesh_times(dev) -> dict[str, dict]:
    """8b's selection and force checks (:func:`_p3m_checks_2m`) and its
    two-level gradient (:func:`_two_level_grad`), then the
    three kernels at 8b's shape and data (the state after 8b's run) beside
    their twins, bounds and (deposit) ``index_add_``; where a P3M force
    evaluation's device time goes, stage by stage; and 8d's CIC kernels
    against their twins."""
    print("[8b mesh] kernel times at the P3M path's shape (CUDA events; plain: host clock, one run)", flush=True)
    sim = MESH_SIMS.pop("p3m")
    _p3m_checks_2m(sim)
    _two_level_grad(sim)
    n_real, grid, block = sim.n_real, 128, p3m.DEFAULT_BLOCK
    x = _p3m_inputs(sim.state.pos_mass, n_real, grid, block)
    del sim
    ps, c4, fm, n = x["ps"], x["c4"], x["fm"], x["ps"].shape[0]
    out: dict[str, dict] = {}

    out["mesh_deposit"] = _deposit_row(f"2M P3M (TSC, N={n})", c4, fm, grid, 3)
    rho = mc.deposit(c4, fm, grid, 3)
    grids = p3m.solve_accel_long(rho, x["h"], EPS2, x["sigma"])
    acc = mc.gather(grids, c4, fm, grid, 3)
    acc_p = None

    def run_gat_plain():
        nonlocal acc_p
        acc_p = mc.gather_plain(grids, c4, fm, grid, 3)

    gat_plain_ms = host_ms(run_gat_plain)
    e_acc = rel_err(acc, acc_p)
    check(e_acc < 1e-5, f"2M: mesh_gather vs plain max-abs/max {e_acc:.3e} < 1e-5")
    out["mesh_gather"] = {
        "max_abs_err": max_abs(acc, acc_p), "ms": cuda_ms(lambda: mc.gather(grids, c4, fm, grid, 3), reps=20),
        "plain_ms": gat_plain_ms, "shape": f"3 x {grid}^3 + ({n}, 4) x 2 -> ({n}, 4), TSC",
        "note": "plain: one run, host clock",
        **bound("mesh_gather", n, 48 * n + 12 * grid**3),
        **_gather_row(f"2M P3M (TSC, N={n})", grids, c4, fm, grid, 3, False, True),
    }
    del acc_p

    args = (ps, x["nbr_idx"], EPS2, x["sigma"], x["rcut"], block, x["mask"])
    sr = p3m.short_range_tiles(*args)
    sr_p = None

    def run_sr_plain():
        nonlocal sr_p
        sr_p = p3m.short_range_tiles(*args, backend="jnp")

    sr_plain_ms = host_ms(run_sr_plain)
    ok, err = _sr_agree(sr, sr_p)
    check(ok, f"2M: short_range vs plain rtol 2e-4, atol 3e-6 of max (max-abs/max {err:.3e})")
    live = int((x["mask"] != 0).sum())
    pairs = live * block * block
    nb, k = x["nbr_idx"].shape
    shares = rcut_shares(ps, x["nbr_idx"], x["mask"], x["rcut"], block)
    dense = dense_slots(ps, x["nbr_idx"], x["mask"], x["rcut"], block)
    out["short_range"] = {
        "max_abs_err": max_abs(sr, sr_p), "ms": cuda_ms(lambda: p3m.short_range_tiles(*args), reps=5),
        "plain_ms": sr_plain_ms, "shape": f"({n}, 4), {nb} tiles of {block}, k {k}, {live} live slots",
        "note": f"{pairs:.4e} slot pairs (mask-0 slots skipped), {shares['in_rcut']:.4e} within rcut, "
                f"{shares['voted']:.4e} through the votes, {dense} slots without votes; plain: one run, "
                f"host clock",
        **sr_bound("short_range", shares, 32 * n + 8 * nb * k, SR_MUFU),
        **_sr_vs_parent("2M P3M (8b)", sr, args),
    }
    del sr_p
    for name, r in ((k, v) for k, v in out.items() if k != "mesh_deposit"):
        print(f"  {name:14s} {r['shape']:48s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})" + (f"  library {r['library_ms']:.4f} ms"
                                                                  if "library_ms" in r else "")
              + f"  max-abs err {r['max_abs_err']:.3e}" + _extras(r) + f"  [{r['note']}]", flush=True)
    stages = _stage_ms(x, n_real, grid, block)
    total = sum(stages.values())
    print(f"  P3M force evaluation at 2M by stage (CUDA events, sum {total:.3f} ms):", flush=True)
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"    {name:45s} {ms:9.3f} ms  {ms / total:6.1%}", flush=True)
    out["mesh_deposit"]["cic_8d"], gather_lib = _pm_kernels_2m(MESH_SIMS.pop("pm"))
    out["mesh_gather"].update(gather_lib)
    return out


# ---------------------------------------------------- the mesh gradients
MESH_GRAD = MESH_KERNELS + ("short_range_bwd",)
# The plain twins of the mesh path, patched to raise inside 9b's, 9c's, 13b's and 13c's windows.
MESH_TWINS = ((p3m, "_short_range_tiles"), (p3m, "_short_range_tiles_bwd"), (p3m, "_k_short_periodic_grads"),
              (mc, "deposit_plain"), (mc, "gather_plain"))
GRAD_2M: dict[str, torch.Tensor] = {}  # 9b's bodies, for the kernel's check after its window


@contextlib.contextmanager
def no_twins():
    """Every plain twin of the mesh path raises while the block runs: a run
    that completes ran no fallback."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in MESH_TWINS]

    def refuse(name):
        def run(*args, **kwargs):
            raise RuntimeError(f"{name}: a plain twin ran on the kernel path")
        return run

    for mod, name, _ in saved:
        setattr(mod, name, refuse(name))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _mutual_kills(mask: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``mask`` with every tile pair (t, j), t != j, (t + j) % 5 == 0 killed
    on both sides: masked slots that keep the pair set mutual."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return mask.masked_fill(((rows + idx) % 5 == 0) & (idx != rows), 0.0)


def _random_cotangent(n: int, dev, seed: int) -> torch.Tensor:
    g = np.random.default_rng(seed).standard_normal((n, 4)).astype(np.float32)
    g[:, 3] = 0.0
    return torch.from_numpy(g).to(dev)


def _bwd_agrees(tag: str, got, want) -> None:
    """The JAX tests' gradient bounds (tests/test_p3m.py:397, 455): x̄ and m̄
    each rtol 1e-4 with atol 1e-5 of its scale, σ̄ rel 1e-3."""
    (dps, dsig), (dps_p, dsig_p) = got, want
    excess = []
    for lanes in (slice(0, 3), slice(3, 4)):
        a, b = dps[:, lanes], dps_p[:, lanes]
        excess.append(float(((a - b).abs() - 1e-4 * b.abs()).max()) / float(b.abs().max()))
    e_sig = abs(float(dsig) - float(dsig_p)) / abs(float(dsig_p))
    check(max(excess) <= 1e-5 and e_sig <= 1e-3 and bool(torch.isfinite(dps).all()),
          f"{tag}: short_range_bwd vs plain, worst (|diff| - 1e-4 |ref|) / scale x̄ {excess[0]:.3e}, "
          f"m̄ {excess[1]:.3e} <= 1e-5; σ̄ rel err {e_sig:.3e} <= 1e-3")


def phase_mesh_grad_checks(dev) -> None:
    """9a: ``short_range_bwd`` against its plain twin on 8a's scenes, with
    tile 3 massless (its rows still get a mass cotangent) and slots masked
    in mutual pairs, for a random cotangent, then on ``pair_checks``'
    planted scenes; with ``--parent`` each bit-equal to the parent's
    kernel."""
    print("[9a mesh grad] short_range_bwd vs plain twin, small shapes", flush=True)
    for n_pad, block in ((8192, 128), (8192, 256), (7936, 256)):
        pos_mass, _, n_real = _clustered(4096, n_pad, dev)
        x = _p3m_inputs(pos_mass, n_real, 32, block)
        ps = x["ps"].clone()
        ps[3 * block : 4 * block, 3] = 0.0
        mask = _mutual_kills(x["mask"], x["nbr_idx"])
        args = (ps, _random_cotangent(n_pad, dev, 9), x["nbr_idx"], EPS2, x["sigma"], x["rcut"], block, mask)
        got, want = p3m.short_range_tiles_bwd(*args), p3m.short_range_tiles_bwd(*args, backend="jnp")
        torch.cuda.synchronize()
        tag = f"N={n_pad} block={block} ({int((mask == 0).sum())} slots off, tile 3 massless)"
        _bwd_agrees(tag, got, want)
        check(float(got[0][3 * block : 4 * block, 3].abs().max()) > 0,
              f"{tag}: the massless tile's rows get a mass cotangent")
        _bwd_parent_equal(tag, got, args)
    planted_short_range_bwd_checks(dev, periodic=False)


def _grad_path(dev, method: str, tag: str, preset: str = "uniform-sphere", **cfg):
    """grad_bench's rollout through ``method`` at full width, with every
    plain twin of the mesh path raising: forward and gradient ms/step, the
    peak memory; the gradient rollout for the profile.  ``cfg``: more of
    the step's config (the periodic box: ``boundary``, ``box_size``,
    ``mesh_interlace``, with the uniform-box preset of that size)."""
    n, k = PM_N, 5
    torch.cuda.reset_peak_memory_stats()
    kw = {"box_size": cfg["box_size"]} if preset == "uniform-box" else {}
    pm_np, vel_np, _ = make_preset(preset, seed=0, G=G, n=n, **kw)
    st = init_state(pm_np, vel_np, n_pad=n, device=dev)
    step = make_step_fn(SimConfig(method=method, pm_grid=128, p3m_nbr_k=32, **cfg), n, n, dev)
    with no_twins():
        t_f, t_g, g, prof = _rollout_times(step, st.pos_mass, st.vel, k, lambda s: (s.pos_mass[:, :3] ** 2).sum() / n)
    print(f"{tag} {preset} N={n} grid 128 k={k}: forward {t_f:.4f} ms/step, gradient {t_g:.4f} ms/step, "
          f"ratio {t_g / t_f:.3f}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, f"{tag}: gradient finite and nonzero")
    GRAD_2M[tag] = st.pos_mass
    gradient = prof[1][1]

    def profiled():
        with no_twins():
            gradient()

    return [(f"{tag} gradient, {k} steps", profiled, {"stages": True})]


def phase_grad_p3m(dev):
    """9b: the P3M gradient path at grad_bench's configuration (k = 32, tile
    256: 8,192 tiles, the flat selection)."""
    return _grad_path(dev, "p3m", "[9b grad p3m]")


def phase_grad_pm(dev):
    """9c: the PM gradient path (CIC, grid 128)."""
    return _grad_path(dev, "pm", "[9c grad pm]")


def phase_mesh_grad_times(dev) -> dict[str, dict]:
    """``short_range_bwd`` at 9b's shape and data (the rollout's first
    bodies, selected as ``accel_p3m`` selects them) beside its twin, for a
    random cotangent."""
    print("[9b mesh grad] short_range_bwd at the P3M gradient path's shape (CUDA events; plain: host clock, "
          "one run)", flush=True)
    pos_mass = GRAD_2M.pop("[9b grad p3m]")
    GRAD_2M.pop("[9c grad pm]")
    n, block = pos_mass.shape[0], p3m.DEFAULT_BLOCK
    x = _p3m_inputs(pos_mass, n, 128, block)
    args = (x["ps"], _random_cotangent(n, dev, 10), x["nbr_idx"], EPS2, x["sigma"], x["rcut"], block, x["mask"])
    got = p3m.short_range_tiles_bwd(*args)
    want = None

    def run_plain():
        nonlocal want
        want = p3m.short_range_tiles_bwd(*args, backend="jnp")

    plain_ms = host_ms(run_plain)
    _bwd_agrees(f"2M uniform-sphere (N={n})", got, want)
    live = int((x["mask"] != 0).sum())
    nb, k = x["nbr_idx"].shape
    shares = rcut_shares(x["ps"], x["nbr_idx"], x["mask"], x["rcut"], block)
    r = {
        "max_abs_err": max_abs(got[0], want[0]), "ms": cuda_ms(lambda: p3m.short_range_tiles_bwd(*args), reps=3),
        "plain_ms": plain_ms, "shape": f"({n}, 4) x 2, {nb} tiles of {block}, k {k}, {live} live slots",
        "note": f"{shares['pairs']:.4e} slot pairs (mask-0 slots skipped), "
                f"{dense_slots(x['ps'], x['nbr_idx'], x['mask'], x['rcut'], block)} of {live} live slots without "
                "votes; plain: one run, host clock",
        **sr_bound("short_range_bwd", shares, 52 * n + 8 * nb * k, SR_MUFU),
        **_bwd_vs_parent("2M uniform-sphere (9b)", got, args),
    }
    print(f"  short_range_bwd {r['shape']:48s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  max-abs err {r['max_abs_err']:.3e}" + _extras(r)
          + f"  [{r['note']}]", flush=True)
    fwd = (x["ps"], x["nbr_idx"], EPS2, x["sigma"], x["rcut"], block, x["mask"])
    _sr_vs_parent("2M uniform-sphere (9b)", p3m.short_range_tiles(*fwd), fwd)
    return {"short_range_bwd": r}


def phase_mesh_grad_crosscheck(dev) -> None:
    """9d: at N = 8,192 (8e's scene) the kernel route's 5-step rollout
    gradient against the ``backend="jnp"`` route's (the twins, autograd
    through the mesh twins), for both methods, by v0 and by dt and G (0-d
    tensors): rtol 2e-3, 6d's bound."""
    pos_mass, vel, n_real = _clustered(4096, 8192, dev)
    for method in ("p3m", "pm"):
        grads = {}
        for route, cfg in (("kernels", SimConfig(method=method)), ("jnp", SimConfig(method=method, backend="jnp"))):
            step = make_step_fn(cfg, 8192, n_real, dev)
            v = vel.clone().requires_grad_()
            dt, g = (torch.tensor(x, device=dev, requires_grad=True) for x in (DT_MAIN, G))
            s = SimState(pos_mass.clone(), v, torch.zeros_like(pos_mass), 0)
            for _ in range(5):
                s = step(s, dt, g)
            loss = (s.pos_mass[:n_real, :3] ** 2).sum() / n_real + (s.vel[:n_real, :3] ** 2).sum()
            grads[route] = torch.autograd.grad(loss, (v, dt, g))
        (gv, gdt, gg), (rv, rdt, rg) = grads["kernels"], grads["jnp"]
        _grad_agrees(gv, rv, f"[9d mesh grad check] N=8192 {method} kernel route vs jnp route, by v0")
        e_dt, e_g = (abs(float(a) - float(b)) / abs(float(b)) for a, b in ((gdt, rdt), (gg, rg)))
        check(e_dt <= 2e-3 and e_g <= 2e-3,
              f"[9d mesh grad check] N=8192 {method}: d/d dt {float(gdt):.6e} (rel err {e_dt:.3e}), "
              f"d/dG {float(gg):.6e} (rel err {e_g:.3e}) vs jnp route, rtol 2e-3")


# ------------------------------- the unfused sym step and the fused exact step
SYM_FORCE = ("sym_diag_prep", "sym_hops", "sym_combine")


def _verlet_on_card(pm, vel, aold, a, n_real):
    """The torch Verlet of ``ops/integrate.py`` on the card, what the
    unfused exact step runs after ``force_exact``."""
    return apply_integrator("verlet", pm, vel, aold, a, DT, valid_mask(pm.shape[0], n_real, pm.device))


def phase_unfused_checks(dev) -> None:
    """10a: ``sym_diag``, ``sym_combine`` and ``fused_step_exact`` against
    their twins at N = 8,192 (nt even), 7,936 (nt odd), 512 (nt = 2) and
    256 (nt = 1), padded rows included; ``fused_step_exact`` against
    ``force_exact`` + the torch Verlet bit for bit; ``accel_sym`` at both
    ``center`` values against ``force_exact``, max-abs over scale < 2e-5."""
    print("[10a unfused sym, fused exact] kernel vs plain twin, small shapes", flush=True)
    rng = np.random.default_rng(10)
    for n_pad, b, n_real in [(8192, 256, 8000), (7936, 256, 7900), (512, 256, 500), (256, 256, 250)]:
        tag = f"N={n_pad} nt={n_pad // b}"
        pm, vel, aold = _inputs(rng, n_pad, n_real, dev)
        pm[0, 3] = 1e5
        src = cf.sym_source_rows(pm, G)
        acc_d, acc_d_p = cf.sym_diag(src, EPS2, b), cf.sym_diag_plain(src, EPS2, b)
        same = torch.equal(acc_d, cf.sym_diag_prep(pm, G, EPS2, b)[1])
        torch.cuda.synchronize()
        check(rel_err(acc_d, acc_d_p) < 1e-5 and same,
              f"{tag}: sym_diag vs plain {rel_err(acc_d, acc_d_p):.3e} < 1e-5, bit-equal to sym_diag_prep's")
        acc_h = cf.sym_hops(src, EPS2, b)
        comb = cf.sym_combine(acc_d, acc_h)
        torch.cuda.synchronize()
        check(torch.equal(comb, cf.sym_combine_plain(acc_d, acc_h)), f"{tag}: sym_combine vs plain bit-equal")
        ex = cf.force_exact(pm, pm, G, EPS2)
        for center in (True, False):
            e = rel_err(cf.accel_sym(pm, G, eps2=EPS2, b=b, center=center)[:n_real], ex[:n_real])
            check(e < 2e-5, f"{tag}: accel_sym center={center} vs force_exact {e:.3e} < 2e-5")
        got = cf.fused_step_exact(pm, vel, aold, DT, G, eps2=EPS2, n_real=n_real)
        want = _verlet_on_card(pm, vel, aold, ex, n_real)
        twin = cf.fused_step_exact_plain(pm, vel, aold, DT, G, EPS2, n_real)
        torch.cuda.synchronize()
        check(all(torch.equal(x, w) for x, w in zip(got, want)),
              f"{tag}: fused_step_exact bit-equal to force_exact + torch Verlet")
        ea, ep, ev = rel_err(got[2], twin[2]), max_abs(got[0], twin[0]), max_abs(got[1], twin[1])
        check(ea < 1e-5 and ep <= 1e-6 and ev <= 1e-6,
              f"{tag}: fused_step_exact vs plain accel {ea:.3e} < 1e-5, |dp| {ep:.3e}, |dv| {ev:.3e} <= 1e-6")


def phase_sym_yoshida4(dev):
    """10b: the unfused sym path at full width with ``integrator="yoshida4"``;
    then (after the counts) a profile of one step, with ``sym_combine``'s
    device time a launch there, where its inputs come straight from the
    kernels before it."""
    _, sim = _sphere_run(dev, "10b unfused sym, yoshida4", chunk=20, integrator="yoshida4")
    return [("10b yoshida4, 1 step", lambda: sim.run(1, chunk=1), {"per_launch": ("sym_combine",)})]


def phase_sym_unfused_verlet(dev) -> None:
    """10b: ``fuse_epilogue=False`` with Verlet, beside phase 5's fused step."""
    ms = _sphere_run(dev, "10b unfused sym, verlet", chunk=20, fuse_epilogue=False)[0]
    fused = MAIN.get("phase 5", float("nan"))
    print(f"  unfused {ms:.4f} vs fused (phase 5) {fused:.4f} ms/step: not fusing the epilogue costs "
          f"{ms - fused:.4f} ms/step ({ms / fused - 1:.2%})", flush=True)


def _exact_forward(step, st, k: int = 3):
    def run():
        s = SimState(st.pos_mass.clone(), st.vel.clone(), torch.zeros_like(st.pos_mass), 0)
        for _ in range(k):
            s = step(s, DT_MAIN, G)
        return s

    return run


def phase_fused_exact(dev):
    """10c: the default's Verlet steps run ``fused_step_exact``.  One chunk
    of 20 steps of ``Simulation(SimConfig())`` at two-galaxy N = 40,002
    (a viewer frame) bit-equal to the same chunk of ``force_exact`` (at the
    wrapper's S) and the torch Verlet, the registry reading 20
    ``fused_step_exact`` launches and no ``force_exact`` for it; then phase
    4's run through that composed step (a gradient's forward), phase 4's
    token, beside phase 4's; after the counts, profiles of a 3-step rollout
    of each."""
    sim = Simulation.from_preset("two-galaxy", SimConfig(), device=dev)
    composed = _composed_step("exact", sim.n_real)
    start, before = sim.state, launch_counts()
    sim.run(20, chunk=20)
    after = launch_counts()
    chunk = {k: after[k] - before[k] for k in ("fused_step_exact", "force_exact")}
    s = start
    for _ in range(20):
        s = composed(s, sim.dt, sim.G)
    same = all(torch.equal(a, b) for a, b in zip((s.pos_mass, s.vel, s.accel),
                                                  (sim.state.pos_mass, sim.state.vel, sim.state.accel)))
    split = exact_split(sim.n_pad, sim.n_pad, sm_count(dev.index))
    check(same and chunk == {"fused_step_exact": 20, "force_exact": 0},
          f"[10c] two-galaxy N={sim.n_real} (n_pad {sim.n_pad}), one chunk of 20 steps of Simulation(SimConfig()): "
          f"bit-equal to force_exact (S={split}) + the torch Verlet: {same}; launches {chunk}")
    ms = MAIN["phase 10c"] = _exact_run(dev, "10c composed exact", composed="exact")
    fused = MAIN.get("phase 4", float("nan"))
    print(f"  fused (phase 4) {fused:.4f} vs composed {ms:.4f} ms/step ({fused / ms - 1:+.2%})", flush=True)
    st, n_real = _two_galaxy(dev)
    return [
        ("fused exact forward (phase 4's step), 3 steps", _exact_forward(make_step_fn(SimConfig(), st.n_pad, n_real, dev), st)),
        ("composed exact forward (force_exact + the torch Verlet), 3 steps", _exact_forward(composed, st)),
    ]


def phase_sym_grad_crosscheck(dev, n: int = 4096) -> None:
    """10d: 6d's rollout at N = 4,096 through the unfused sym route with
    yoshida4 against the ``backend="jnp"`` route, by v0, dt and G, rtol
    2e-3; and a gradient request through ``fuse_integrate=True`` raises."""
    rng = np.random.default_rng(7)
    pm = torch.from_numpy(np.concatenate(
        [rng.standard_normal((n, 3)), rng.uniform(10, 50, (n, 1))], axis=1).astype(np.float32)).to(dev)
    grads = {}
    for name, cfg in (("sym yoshida4", SimConfig(force_mode="sym", integrator="yoshida4")),
                      ("jnp yoshida4", SimConfig(backend="jnp", integrator="yoshida4"))):
        step = make_step_fn(cfg, n, n, dev)
        v = torch.zeros((n, 4), device=dev, requires_grad=True)
        dt, g = (torch.tensor(x, device=dev, requires_grad=True) for x in (1e-2, G))
        s = SimState(pm.clone(), v, torch.zeros_like(pm), 0)
        for _ in range(10):
            s = step(s, dt, g)
        grads[name] = torch.autograd.grad((s.pos_mass[0, :3] ** 2).sum(), (v, dt, g))
    (gv, gdt, gg), (rv, rdt, rg) = grads["sym yoshida4"], grads["jnp yoshida4"]
    _grad_agrees(gv, rv, f"[10d grad check] N={n} yoshida4 sym route vs jnp route, by v0")
    e_dt, e_g = (abs(float(a) - float(b)) / abs(float(b)) for a, b in ((gdt, rdt), (gg, rg)))
    check(e_dt <= 2e-3 and e_g <= 2e-3,
          f"[10d grad check] N={n} yoshida4 sym: d/d dt {float(gdt):.6e} (rel err {e_dt:.3e}), "
          f"d/dG {float(gg):.6e} (rel err {e_g:.3e}) vs jnp route, rtol 2e-3")
    step = make_step_fn(SimConfig(fuse_integrate=True), n, n, dev)
    v = torch.zeros((n, 4), device=dev, requires_grad=True)
    try:
        step(SimState(pm.clone(), v, torch.zeros_like(pm), 0), 1e-2, G)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    check("no gradient" in raised, f"[10d grad check] a gradient request through fuse_integrate=True raises: {raised!r}")


def phase_uncentred_sym(dev) -> None:
    """The uncentred route (``accel_sym(center=False)``: torch-built source
    rows -> ``sym_diag`` -> ``sym_hops`` -> ``sym_combine``), on no main
    path, at uniform-sphere N = 262,144, against ``center=True``."""
    n = 262144
    pm_np, vel_np, _ = make_preset("uniform-sphere", seed=0, G=G, n=n)
    st = init_state(pm_np, vel_np, n_pad=n, device=dev)
    pm = morton_reorder(st.pos_mass, st.vel, st.accel, n_real=n)[0]
    a_c = cf.accel_sym(pm, G, eps2=EPS2, b=GPU_TILE, center=True)
    for _ in range(3):
        a_u = cf.accel_sym(pm, G, eps2=EPS2, b=GPU_TILE, center=False)
    torch.cuda.synchronize()
    e = rel_err(a_u, a_c)
    check(e < 2e-5, f"[10e uncentred sym] N={n}: center=False vs center=True {e:.3e} < 2e-5")


def phase_unfused_times(dev) -> dict[str, dict]:
    """The three kernels beside their twins at the main-path shapes:
    ``sym_combine`` and ``sym_diag`` at 10b's (uniform-sphere N = 262,144,
    tile 256), ``sym_combine`` with L2 warm and flushed and beside
    ``torch.add`` (its library call); ``fused_step_exact`` at 10c's
    (two-galaxy n_pad 40,192)."""
    print("[10 unfused sym, fused exact] times at main-path shapes (CUDA events)", flush=True)
    out: dict[str, dict] = {}
    n, b = 262144, GPU_TILE
    pm_np, vel_np, _ = make_preset("uniform-sphere", seed=0, G=G, n=n)
    st = init_state(pm_np, vel_np, n_pad=n, device=dev)
    pm = morton_reorder(st.pos_mass, st.vel, st.accel, n_real=n)[0]
    src = cf.sym_source_rows(pm, G)
    acc_d, acc_d_p = cf.sym_diag(src, EPS2, b), cf.sym_diag_plain(src, EPS2, b)
    torch.cuda.synchronize()
    check(rel_err(acc_d, acc_d_p) < 1e-5, f"uniform-sphere N={n}: sym_diag vs plain {rel_err(acc_d, acc_d_p):.3e} < 1e-5")
    out["sym_diag"] = {
        "max_abs_err": max_abs(acc_d, acc_d_p),
        "ms": cuda_ms(lambda: cf.sym_diag(src, EPS2, b), reps=20),
        "plain_ms": cuda_ms(lambda: cf.sym_diag_plain(src, EPS2, b), reps=2),
        "shape": f"({n}, 4), tile {b}",
        **bound("sym_diag", n * (b - 1), 32 * n, rsqrts=n * (b - 1)),
    }
    del acc_d_p
    acc_h = cf.sym_hops(src, EPS2, b)
    comb, comb_p = cf.sym_combine(acc_d, acc_h), cf.sym_combine_plain(acc_d, acc_h)
    torch.cuda.synchronize()
    check(torch.equal(comb, comb_p), f"uniform-sphere N={n}: sym_combine vs plain bit-equal")
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)  # 128 MB > the 50 MB L2
    calls = {
        "kernel": lambda: cf.sym_combine(acc_d, acc_h),
        "plain": lambda: cf.sym_combine_plain(acc_d, acc_h),
        "library": lambda: torch.add(acc_d, acc_h),
    }
    warm = {k: cuda_ms(f, reps=50) for k, f in calls.items()}
    cold = {k: cuda_ms_cold(f, 50, flush) for k, f in calls.items()}
    # The kernel and torch.add in turns (kernel, add, add, kernel), three
    # rounds, L2 flushed: does the kernel lose by more than the spread?
    turns = {"kernel": [], "library": []}
    for _ in range(3):
        for k in ("kernel", "library", "library", "kernel"):
            turns[k].append(cuda_ms_cold(calls[k], 50, flush))
    mean = {k: statistics.mean(v) for k, v in turns.items()}
    spread = max(max(v) - min(v) for v in turns.values())
    verdict = "loses" if mean["kernel"] - mean["library"] > spread else "does not lose"
    print(f"  sym_combine vs torch.add in turns, L2 flushed (kernel, add, add, kernel) x 3: kernel "
          f"{[round(t, 5) for t in turns['kernel']]} mean {mean['kernel']:.5f} ms, torch.add "
          f"{[round(t, 5) for t in turns['library']]} mean {mean['library']:.5f} ms, spread {spread:.5f} ms: "
          f"the kernel {verdict} by more than the spread", flush=True)
    out["sym_combine"] = {
        "max_abs_err": max_abs(comb, comb_p),
        "ms": cold["kernel"],
        "plain_ms": cold["plain"],
        "library_ms": cold["library"],
        "library_note": "torch.add(acc_diag, acc_hop), L2 flushed",
        "shape": f"2 x ({n}, 4) in, ({n}, 4) out",
        "note": "L2 flushed; L2 warm " + ", ".join(f"{k} {t:.4f} ms" for k, t in warm.items())
                + f"; in turns kernel {mean['kernel']:.5f}, torch.add {mean['library']:.5f}, spread {spread:.5f}",
        **bound("sym_combine", n, 48 * n),
    }
    del flush

    st, n_real = _two_galaxy(dev)
    n = st.n_pad
    pm, vel = st.pos_mass, st.vel
    aold = cf.force_exact(pm, pm, G, EPS2)
    got = cf.fused_step_exact(pm, vel, aold, DT_MAIN, G, eps2=EPS2, n_real=n_real)
    twin = cf.fused_step_exact_plain(pm, vel, aold, DT_MAIN, G, EPS2, n_real)
    want = apply_integrator("verlet", pm, vel, aold, cf.force_exact(pm, pm, G, EPS2), DT_MAIN,
                            valid_mask(n, n_real, dev))
    torch.cuda.synchronize()
    check(all(torch.equal(x, w) for x, w in zip(got, want)),
          f"two-galaxy N={n}: fused_step_exact bit-equal to force_exact + torch Verlet")
    check(rel_err(got[2], twin[2]) < 1e-5, f"two-galaxy N={n}: fused_step_exact vs plain {rel_err(got[2], twin[2]):.3e} < 1e-5")
    # Pairs only: the Verlet's ~33 FLOP a row is 1e-6 of them here.
    out["fused_step_exact"] = {
        "max_abs_err": max_abs(got[2], twin[2]),
        "ms": cuda_ms(lambda: cf.fused_step_exact(pm, vel, aold, DT_MAIN, G, eps2=EPS2, n_real=n_real), reps=20),
        "plain_ms": cuda_ms(lambda: cf.fused_step_exact_plain(pm, vel, aold, DT_MAIN, G, EPS2, n_real), reps=3),
        "shape": f"3 x ({n}, 4) in, 3 x ({n}, 4) out",
        "note": "force_exact + torch Verlet "
                f"{cuda_ms(lambda: _verlet_on_card(pm, vel, aold, cf.force_exact(pm, pm, G, EPS2), n_real), reps=20):.4f} ms",
        **bound("fused_step_exact", n * n, 96 * n, rsqrts=n * n),
    }
    _print_times(out)
    return out


def phase_exact_times(dev, times: dict[str, dict]) -> None:
    """``force_exact`` and ``fused_step_exact``, the launch alone, at the
    exact paths' two-galaxy n_pad 40,192 and at uniform-sphere N = 262,144
    (Morton order): S, the cluster and the time at each; the guarded
    ``rsqrtf`` instance (eps2 = 1e-14) beside the ftz one in turns; at
    40,192 ``force_exact`` at every S from 1 to 8; with ``--parent`` the
    parent's kernels in turns (their mean at 40,192 goes into the kernels
    line), bit-equal at the same S.
    Adds a line a shape to each kernel's note."""
    print("[3, 10 exact kernels] times at 40,192 and 262,144, the launch alone (CUDA events)", flush=True)
    lib = _build.load_library()
    st, n_real = _two_galaxy(dev)
    pm_np, vel_np, _ = make_preset("uniform-sphere", seed=0, G=G, n=262144)
    sphere = init_state(pm_np, vel_np, n_pad=262144, device=dev)
    shapes = (("two-galaxy", st.pos_mass, st.vel, n_real, 20),
              ("uniform-sphere", *morton_reorder(sphere.pos_mass, sphere.vel, sphere.accel, n_real=262144)[:2],
               262144, 3))
    for name, pm, vel, n_real, reps in shapes:
        n = pm.shape[0]
        split = exact_split(n, n, sm_count(dev.index))
        aold = cf.force_exact(pm, pm, G, EPS2)
        outs = tuple(torch.empty_like(pm) for _ in range(3))
        runs = {
            "force_exact": (lambda e=EPS2, s=split: force_exact_split(pm, pm, G, e, s, outs[2]),
                            lambda: _parent_call(PARENT["lib"].nb_force_exact, pm, pm, outs[2], n, n, G, EPS2,
                                                 split),
                            (parent_force_exact, pm, pm, G, EPS2)),
            "fused_step_exact": (
                lambda e=EPS2, s=split: fused_exact_split(pm, vel, aold, DT_MAIN, G, e, n_real, s, outs),
                lambda: _parent_call(PARENT["lib"].nb_fused_step_exact, pm, vel, aold, *outs, n, n_real, DT_MAIN, G,
                                     EPS2, split),
                (parent_fused_step_exact, pm, vel, aold, DT_MAIN, G, EPS2, n_real)),
        }
        for kernel, (fn, parent_fn, parent_args) in runs.items():
            got = fn()
            got = tuple(t.clone() for t in got) if isinstance(got, tuple) else got.clone()
            ms = cuda_ms(fn, reps=reps)
            t = [cuda_ms(lambda e=e: fn(e), reps=reps) for e in (1e-14, EPS2, EPS2, 1e-14)]
            line = (f"{name} n {n}: S {split} ({f'a cluster of {split}' if split > 1 else 'no cluster'}), "
                    f"{ms:.4f} ms; in turns guarded rsqrtf (eps2 1e-14) {t[0]:.4f} / {t[3]:.4f}, "
                    f"ftz {t[1]:.4f} / {t[2]:.4f}")
            if PARENT:
                _exact_vs_parent(f"{name} n {n} {kernel}", split, got, *parent_args)
                turns = vs_parent(f"{name} n {n} {kernel}, the launch alone", fn, parent_fn, reps=reps)
                line += f"; parent {turns['parent_ms']:.4f}, this {turns['this_ms']:.4f} (in turns)"
                if name == "two-galaxy":
                    times[kernel].update(turns)
            print(f"  {kernel}: {line}", flush=True)
            note = times[kernel].get("note")
            times[kernel]["note"] = f"{note}; {line}" if note else line
        if n < 100000:
            sweep = {s: cuda_ms(lambda s=s: force_exact_split(pm, pm, G, EPS2, s, outs[2]), reps=reps)
                     for s in range(1, EXACT_MAX_SPLIT + 1)}
            print(f"  force_exact at {name} n {n} by S (exact_split gives {split}): "
                  + ", ".join(f"{s} {v:.4f}" for s, v in sweep.items()) + " ms", flush=True)


# --------------------------------------------------------------- fast mode
# Kernel vs twin: the kernel's sums are f32 (csrc/mma.cuh: each 16-source
# chunk on the tensor cores, round-to-nearest adds within a 128-source tile,
# TwoSum across tiles), the twin's f64.  A numpy emulation of f32 tile sums
# on 256 two-galaxy rows gave 3.3e-5 of scale; the bound leaves 6x of room.
FAST_TWIN_TOL = 2e-4
# Against f64: the bf16 weight noise (tests/test_pallas.py:50-68), and a
# heavy body's own row (tests/test_sym.py:149-172).
FAST_F64_TOL, FAST_CENTRAL_TOL = 5e-3, 6e-3
# The softenings 11a's twin checks run at: the default, whose cube is a
# normal float (the kernels' ftz rsqrt), and 1e-14, whose cube is
# subnormal (their instance with rsqrtf and its guard).
FAST_EPS2 = (EPS2, 1e-14)


def _accel_f64(pm: np.ndarray, rows: np.ndarray, chunk: int = 128) -> np.ndarray:
    """float64 numpy direct sum for the target ``rows`` against every row of
    ``pm`` (the self pair adds zero: its separation is zero)."""
    x = pm[:, :3].astype(np.float64)
    gm = G * pm[:, 3].astype(np.float64)
    out = np.empty((len(rows), 3))
    for c0 in range(0, len(rows), chunk):
        k = rows[c0 : c0 + chunk]
        d = x[None, :, :] - x[k, None, :]
        w = gm[None, :] * (np.sum(d * d, axis=-1) + EPS2) ** -1.5
        out[c0 : c0 + len(k)] = np.einsum("kj,kjc->kc", w, d)
    return out


def _fast_vs_f64(tag: str, pm: torch.Tensor, rows: np.ndarray, heavy: np.ndarray) -> None:
    """``force_fast`` on the card against f64 on ``rows``: max error over
    scale, the ``heavy`` bodies' own rows, and the momentum rate (net force
    over the summed |m a|, which bf16 weights need not keep at 0)."""
    a = cf.force_fast(pm, pm, G, EPS2)
    _parent_equal(f"[11a fast vs f64] {tag} force_fast", a, parent_force_fast, pm, pm, G, EPS2)
    pm_np, a_np = pm.cpu().numpy(), a.cpu().numpy()[:, :3].astype(np.float64)
    want = _accel_f64(pm_np, rows)
    err = float(np.abs(a_np[rows] - want).max() / np.abs(want).max())
    at = {int(r): i for i, r in enumerate(rows)}
    central = [float(np.abs(a_np[h] - want[at[h]]).max() / np.abs(want[at[h]]).max()) for h in heavy]
    m = pm_np[:, 3:4].astype(np.float64)
    mom = float(np.abs((m * a_np).sum(0)).max() / (np.abs(m * a_np).sum(0).max()))
    check(err <= FAST_F64_TOL and max(central, default=0.0) <= FAST_CENTRAL_TOL,
          f"[11a fast vs f64] {tag}: max-abs/scale {err:.3e} <= {FAST_F64_TOL}, heavy rows "
          f"{[f'{c:.3e}' for c in central]} <= {FAST_CENTRAL_TOL}; momentum rate |sum m a| / sum |m a| {mom:.3e}")


def _fast_twin_checks(tag: str, pm, vel, aold, n_real: int, eps2: float) -> None:
    """11a on one scene and softening: ``force_fast`` against its twin,
    ``fused_step_fast`` bit-equal to ``force_fast`` + the torch Verlet and
    against its twin, padded rows frozen; with ``--parent`` both bit-equal
    to the parent's kernels."""
    ff, ff_p = cf.force_fast(pm, pm, G, eps2), cf.force_fast_plain(pm, pm, G, eps2)
    torch.cuda.synchronize()
    check(rel_err(ff, ff_p) < FAST_TWIN_TOL and bool((ff[:, 3] == 0).all()),
          f"{tag}: force_fast vs plain {rel_err(ff, ff_p):.3e} < {FAST_TWIN_TOL}, w lane 0")
    _parent_equal(f"{tag} force_fast", ff, parent_force_fast, pm, pm, G, eps2)
    got = cf.fused_step_fast(pm, vel, aold, DT, G, eps2=eps2, n_real=n_real)
    want = _verlet_on_card(pm, vel, aold, ff, n_real)
    twin = cf.fused_step_fast_plain(pm, vel, aold, DT, G, eps2, n_real)
    torch.cuda.synchronize()
    check(all(torch.equal(x, w) for x, w in zip(got, want)),
          f"{tag}: fused_step_fast bit-equal to force_fast + torch Verlet")
    _parent_equal(f"{tag} fused_step_fast", got, parent_fused_step_fast, pm, vel, aold, DT, G, eps2, n_real)
    # What the accel bound moves in one step: dt/2 of it in v, dt^2 in x.
    da = FAST_TWIN_TOL * float(twin[2].abs().max())
    ea, ep, ev = rel_err(got[2], twin[2]), max_abs(got[0], twin[0]), max_abs(got[1], twin[1])
    check(ea < FAST_TWIN_TOL and ep <= 1e-6 + da * DT * DT and ev <= 1e-6 + da * DT / 2,
          f"{tag}: fused_step_fast vs plain accel {ea:.3e} < {FAST_TWIN_TOL}, |dp| {ep:.3e} <= "
          f"{1e-6 + da * DT * DT:.3e}, |dv| {ev:.3e} <= {1e-6 + da * DT / 2:.3e}")
    frozen = (torch.equal(got[0][n_real:], pm[n_real:]) and torch.equal(got[1][n_real:], vel[n_real:])
              and bool((got[2][n_real:] == 0).all()))
    check(frozen, f"{tag}: fused_step_fast padded rows frozen, stored accel zero")


def phase_fast_checks(dev) -> None:
    """11a: ``force_fast`` and ``fused_step_fast`` against their twins at N =
    8,192, 7,936, 512 and 256 (a heavy body, padded rows); ``force_fast``
    on a disjoint source set (and a ragged one) and with the diagonal at
    unaligned offsets, negative and restricted too; ``fused_step_fast`` bit-equal to ``force_fast`` +
    the torch Verlet; each at both of FAST_EPS2 (both kernel instances);
    then against f64 on the two-galaxy scene and on a planted
    near-coincident pair."""
    print("[11a fast mode] kernel vs plain twin, small shapes", flush=True)
    rng = np.random.default_rng(11)
    for n_pad, n_real in [(8192, 8000), (7936, 7900), (512, 500), (256, 250)]:
        pm, vel, aold = _inputs(rng, n_pad, n_real, dev)
        pm[0, 3] = 1e7
        for eps2 in FAST_EPS2:
            _fast_twin_checks(f"N={n_pad}" + ("" if eps2 == EPS2 else f" eps2 {eps2:g}"), pm, vel, aold, n_real,
                              eps2)
    # pm is the N = 256 scene; the diagonal forms at N = 8,192.
    pm, _, _ = _inputs(rng, 8192, 8192, dev)
    pm[4000, 3] = 1e7
    for (what, tgt, src, diag, rows), eps2 in itertools.product((
        ("disjoint sets (NO_DIAG)", pm[:4096], pm[4096:], (cf.NO_DIAG, 0, cf.NO_DIAG), slice(None)),
        ("diagonal at offset 1,000", pm[1000:5000], pm, (1000, 0, 4000), slice(None)),
        ("diagonal at offset 1,000, rows [500, 3,100)", pm[1000:5000], pm, (1000, 500, 3100), slice(500, 3100)),
        ("diagonal at offset -1,000, rows [1,000, 4,000)", pm[:4000], pm[1000:], (-1000, 1000, 4000), slice(None)),
        ("1,000 targets x 1,999 sources (ragged)", pm[:1000], pm[1000:2999], (cf.NO_DIAG, 0, cf.NO_DIAG), slice(None)),
    ), FAST_EPS2):
        what += "" if eps2 == EPS2 else f", eps2 {eps2:g}"
        k, p = cf.force_fast(tgt, src, G, eps2, diag), cf.force_fast_plain(tgt, src, G, eps2, diag)
        torch.cuda.synchronize()
        e = rel_err(k[rows], p[rows])
        check(e < FAST_TWIN_TOL, f"N=8192 force_fast {what} vs plain {e:.3e} < {FAST_TWIN_TOL}")
        _parent_equal(f"N=8192 force_fast {what}", k, parent_force_fast, tgt, src, G, eps2, diag)
    st, n_real = _two_galaxy(dev)
    heavy = np.argsort(-st.pos_mass[:, 3].cpu().numpy())[:2]
    rows = np.unique(np.concatenate([heavy, np.random.default_rng(12).choice(n_real, 2046, replace=False)]))
    _fast_vs_f64(f"two-galaxy N={n_real} (n_pad {st.n_pad}), {len(rows)} rows", st.pos_mass, rows, heavy)
    n = 4096
    pm_np = np.concatenate([rng.normal(scale=2.0, size=(n, 3)), rng.uniform(1, 50, (n, 1))], axis=1).astype(np.float32)
    pm_np[1, :3] = pm_np[0, :3] + 1e-4  # closer than the softening length
    _fast_vs_f64(f"near-coincident pair N={n}", torch.from_numpy(pm_np).to(dev), np.arange(n), np.array([0, 1]))


def phase_fast_sphere(dev) -> None:
    """11b: bench.py's fast configuration, uniform-sphere N = 262,144,
    ``morton_every=64``, 1 warm and 2 timed chunks of 20 steps, phase 5's
    token."""
    MAIN["phase 11b"] = _sphere_run(dev, "11b fast", chunk=20, force_mode="fast")[0]


def phase_fast_two_galaxy(dev):
    """11c: phase 4's run with ``force_mode="fast"`` (``fused_step_fast``)
    and phase 4's token."""
    ms = MAIN["phase 11c"] = _exact_run(dev, "11c fast", force_mode="fast")
    print(f"  fast {ms:.4f} vs exact (phase 4) {MAIN.get('phase 4', float('nan')):.4f} ms/step", flush=True)
    st, n_real = _two_galaxy(dev)
    cfg = SimConfig(force_mode="fast")
    return [("fast forward, 3 steps", _exact_forward(make_step_fn(cfg, st.n_pad, n_real, dev), st))]


def phase_fused_fast(dev):
    """11c: the same through ``force_fast`` and the torch Verlet (a
    gradient's forward), beside the fused step."""
    ms = _exact_run(dev, "11c composed fast", force_mode="fast", composed="fast")
    fused = MAIN.get("phase 11c", float("nan"))
    print(f"  fused fast {fused:.4f} vs composed fast {ms:.4f} ms/step ({fused / ms - 1:+.2%})", flush=True)
    st, n_real = _two_galaxy(dev)
    return [("composed fast forward, 3 steps", _exact_forward(_composed_step("fast", n_real), st))]


def phase_fast_grad_crosscheck(dev, n: int = 4096) -> None:
    """11d: 6d's rollout at N = 4,096 through the fast route against the
    ``backend="jnp"`` route, by v0, dt and G, within 5e-3 of scale (the
    JAX package's fast-class gradient bound, BASELINE.md:262); and a
    gradient request through the fused fast step raises."""
    rng = np.random.default_rng(7)
    pm = torch.from_numpy(np.concatenate(
        [rng.standard_normal((n, 3)), rng.uniform(10, 50, (n, 1))], axis=1).astype(np.float32)).to(dev)
    grads = {}
    for name, cfg in (("fast", SimConfig(force_mode="fast")), ("jnp", SimConfig(backend="jnp"))):
        step = make_step_fn(cfg, n, n, dev)
        v = torch.zeros((n, 4), device=dev, requires_grad=True)
        dt, g = (torch.tensor(x, device=dev, requires_grad=True) for x in (1e-2, G))
        s = SimState(pm.clone(), v, torch.zeros_like(pm), 0)
        for _ in range(10):
            s = step(s, dt, g)
        grads[name] = torch.autograd.grad((s.pos_mass[0, :3] ** 2).sum(), (v, dt, g))
    (gv, gdt, gg), (rv, rdt, rg) = grads["fast"], grads["jnp"]
    e_v = max_abs(gv, rv) / float(rv.abs().max())
    e_dt, e_g = (abs(float(a) - float(b)) / abs(float(b)) for a, b in ((gdt, rdt), (gg, rg)))
    check(max(e_v, e_dt, e_g) <= 5e-3,
          f"[11d grad check] N={n} fast route vs jnp route: by v0 {e_v:.3e}, d/d dt {float(gdt):.6e} "
          f"(rel err {e_dt:.3e}), d/dG {float(gg):.6e} (rel err {e_g:.3e}) <= 5e-3")
    step = make_step_fn(SimConfig(force_mode="fast", fuse_integrate=True), n, n, dev)
    v = torch.zeros((n, 4), device=dev, requires_grad=True)
    try:
        step(SimState(pm.clone(), v, torch.zeros_like(pm), 0), 1e-2, G)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    check("no gradient" in raised, f"[11d grad check] a gradient request through the fused fast step raises: {raised!r}")


def phase_fast_times(dev) -> dict[str, dict]:
    """The two kernels beside their twins and ``force_exact`` at the main
    paths' shapes: ``force_fast`` at 11b's (uniform-sphere N = 262,144,
    Morton order) and 11c's (two-galaxy n_pad 40,192), ``fused_step_fast``
    at 11c's.  No one PyTorch call computes either function."""
    print("[11 fast mode] times at main-path shapes (CUDA events)", flush=True)
    out: dict[str, dict] = {}
    n = 262144
    pm_np, vel_np, _ = make_preset("uniform-sphere", seed=0, G=G, n=n)
    st = init_state(pm_np, vel_np, n_pad=n, device=dev)
    pm, vel, _ = morton_reorder(st.pos_mass, st.vel, st.accel, n_real=n)
    ff = cf.force_fast(pm, pm, G, EPS2)
    t0 = time.perf_counter()
    ff_p = cf.force_fast_plain(pm, pm, G, EPS2)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(rel_err(ff, ff_p) < FAST_TWIN_TOL, f"uniform-sphere N={n}: force_fast vs plain {rel_err(ff, ff_p):.3e} < {FAST_TWIN_TOL}")
    _parent_equal(f"uniform-sphere N={n} (11b) force_fast", ff, parent_force_fast, pm, pm, G, EPS2)
    t = _fast_times(dev, pm, reps=5)
    if PARENT:
        guarded = [cuda_ms(lambda e=e: cf.force_fast(pm, pm, G, e), reps=5) for e in (1e-14, EPS2, EPS2, 1e-14)]
        print(f"    uniform-sphere N={n} force_fast, rsqrtf with its guard (eps2 = 1e-14, eps2^3 subnormal) beside "
              f"the ftz rsqrt (eps2 = {EPS2:g}), wrapper, in turns: guarded {guarded[0]:.4f} / {guarded[3]:.4f} ms, "
              f"ftz {guarded[1]:.4f} / {guarded[2]:.4f} ms", flush=True)
    out["force_fast"] = {
        "max_abs_err": max_abs(ff, ff_p),
        "ms": t["kernel"],
        "plain_ms": plain_ms,
        "shape": f"({n}, 4) x ({n}, 4)",
        "note": f"the launch alone; with the wrapper's limb prep {t['wrapper']:.4f} ms; force_exact "
                f"{t['exact']:.4f} ms; plain one run, host clock",
        # pm, the (N, 16) bf16 limbs and the output: 64 B a row.
        **bound("force_fast", n * n, 64 * n, rsqrts=n * n),
        **_fast_vs_parent(f"uniform-sphere N={n} (11b)", dev, pm, reps=5),
    }
    del ff_p
    sphere_note = _fast_step_at_sphere(dev, pm, vel, ff)
    st, n_real = _two_galaxy(dev)
    n = st.n_pad
    pm, vel = st.pos_mass, st.vel
    ff, ff_p = cf.force_fast(pm, pm, G, EPS2), cf.force_fast_plain(pm, pm, G, EPS2)
    torch.cuda.synchronize()
    check(rel_err(ff, ff_p) < FAST_TWIN_TOL, f"two-galaxy N={n}: force_fast vs plain {rel_err(ff, ff_p):.3e} < {FAST_TWIN_TOL}")
    _parent_equal(f"two-galaxy N={n} (11c) force_fast", ff, parent_force_fast, pm, pm, G, EPS2)
    t = _fast_times(dev, pm, reps=20)
    tg_parent = _fast_vs_parent(f"two-galaxy N={n} (11c)", dev, pm, reps=20)
    out["force_fast"]["note"] += (
        f"; two-galaxy n_pad {n}: kernel {t['kernel']:.4f} ms (with prep {t['wrapper']:.4f}), plain "
        f"{cuda_ms(lambda: cf.force_fast_plain(pm, pm, G, EPS2), reps=3):.4f} ms, bound "
        f"{bound('force_fast', n * n, 64 * n, rsqrts=n * n)['bound_ms']:.4f} ms, force_exact {t['exact']:.4f} ms, "
        f"max-abs err {max_abs(ff, ff_p):.3e} (scale {float(ff_p.abs().max()):.4e})"
        + (f"; parent {tg_parent['parent_ms']:.4f} ms, this {tg_parent['this_ms']:.4f} ms (in turns)" if tg_parent
           else ""))
    aold = ff
    got = cf.fused_step_fast(pm, vel, aold, DT_MAIN, G, eps2=EPS2, n_real=n_real)
    twin = cf.fused_step_fast_plain(pm, vel, aold, DT_MAIN, G, EPS2, n_real)
    want = apply_integrator("verlet", pm, vel, aold, cf.force_fast(pm, pm, G, EPS2), DT_MAIN,
                            valid_mask(n, n_real, dev))
    torch.cuda.synchronize()
    check(all(torch.equal(x, w) for x, w in zip(got, want)),
          f"two-galaxy N={n}: fused_step_fast bit-equal to force_fast + torch Verlet")
    check(rel_err(got[2], twin[2]) < FAST_TWIN_TOL, f"two-galaxy N={n}: fused_step_fast vs plain {rel_err(got[2], twin[2]):.3e} < {FAST_TWIN_TOL}")
    _parent_equal(f"two-galaxy N={n} (11c) fused_step_fast", got, parent_fused_step_fast, pm, vel, aold, DT_MAIN,
                       G, EPS2, n_real)
    frag = cf.fragment_order(cf.limbs_bf16(pm, G))
    outs = tuple(torch.empty_like(pm) for _ in range(3))
    lib = _build.load_library()
    fused = lambda: launch("fused_step_fast", dev, lib.nb_fused_step_fast, pm, frag, vel, aold, *outs,  # noqa: E731
                           n, n_real, DT_MAIN, EPS2)
    wrapper = cuda_ms(lambda: cf.fused_step_fast(pm, vel, aold, DT_MAIN, G, eps2=EPS2, n_real=n_real), reps=20)
    fused_exact = cuda_ms(lambda: cf.fused_step_exact(pm, vel, aold, DT_MAIN, G, eps2=EPS2, n_real=n_real), reps=20)
    out["fused_step_fast"] = {
        "max_abs_err": max_abs(got[2], twin[2]),
        "ms": cuda_ms(fused, reps=20),
        "plain_ms": cuda_ms(lambda: cf.fused_step_fast_plain(pm, vel, aold, DT_MAIN, G, EPS2, n_real), reps=3),
        "shape": f"3 x ({n}, 4) in, 3 x ({n}, 4) out",
        "note": f"the launch alone; with the wrapper's limb prep {wrapper:.4f} ms; fused_step_exact "
                f"{fused_exact:.4f} ms; {sphere_note}",
        # 3 rows in, the limbs, 3 rows out: 128 B a row; pairs only.
        **bound("fused_step_fast", n * n, 128 * n, rsqrts=n * n),
    }
    if PARENT:
        p_outs = tuple(torch.empty_like(pm) for _ in range(3))
        out["fused_step_fast"].update(vs_parent(
            f"two-galaxy N={n} (11c) fused_step_fast, the launch alone", fused,
            lambda: _parent_call(PARENT["lib"].nb_fused_step_fast, pm, frag, vel, aold, *p_outs, n, n_real, DT_MAIN,
                                 EPS2), reps=20))
    _print_times(out)
    return out


def _fast_step_at_sphere(dev, pm: torch.Tensor, vel: torch.Tensor, aold: torch.Tensor) -> str:
    """11b's step at its shape (uniform-sphere N = 262,144, Morton order,
    no padding): ``fused_step_fast`` bit-equal to ``force_fast`` + the torch
    Verlet with the valid mask and within FAST_TWIN_TOL of its plain twin;
    its time (the launch alone and the wrapper) beside that composed route,
    the route 11b ran before, and its bound.  Returns a note for the
    kernel's row."""
    n = pm.shape[0]
    tag = f"uniform-sphere N={n} (11b, Morton order)"
    got = cf.fused_step_fast(pm, vel, aold, DT_MAIN, G, eps2=EPS2, n_real=n)
    want = apply_integrator("verlet", pm, vel, aold, cf.force_fast(pm, pm, G, EPS2), DT_MAIN, valid_mask(n, n, dev))
    t0 = time.perf_counter()
    twin = cf.fused_step_fast_plain(pm, vel, aold, DT_MAIN, G, EPS2, n)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.equal(x, w) for x, w in zip(got, want)),
          f"{tag}: fused_step_fast bit-equal to force_fast + torch Verlet")
    err, err_abs = rel_err(got[2], twin[2]), max_abs(got[2], twin[2])
    check(err < FAST_TWIN_TOL, f"{tag}: fused_step_fast vs plain {err:.3e} < {FAST_TWIN_TOL}")
    del twin
    lib = _build.load_library()
    frag = cf.fragment_order(cf.limbs_bf16(pm, G))
    outs = tuple(torch.empty_like(pm) for _ in range(3))
    composed = _composed_step("fast", n)
    kernel = cuda_ms(lambda: launch("fused_step_fast", dev, lib.nb_fused_step_fast, pm, frag, vel, aold, *outs,
                                    n, n, DT_MAIN, EPS2), reps=5)
    wrapper = cuda_ms(lambda: cf.fused_step_fast(pm, vel, aold, DT_MAIN, G, eps2=EPS2, n_real=n), reps=5)
    route = cuda_ms(lambda: composed(SimState(pm, vel, aold, 0), DT_MAIN, G), reps=5)
    b = bound("fused_step_fast", n * n, 128 * n, rsqrts=n * n)
    note = (f"at 11b's uniform-sphere {n} (Morton order): the launch alone {kernel:.4f} ms, with the limb prep "
            f"{wrapper:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}), force_fast + the torch Verlet "
            f"{route:.4f} ms (the wrapper {wrapper / route - 1:+.2%}), plain {plain_ms:.4f} ms (one run, host "
            f"clock), max-abs err vs plain {err_abs:.3e}")
    print(f"    fused_step_fast {note}", flush=True)
    return note


def _fast_vs_parent(tag: str, dev, pm: torch.Tensor, reps: int) -> dict:
    """With ``--parent``: ``force_fast(pm, pm)``'s launch alone beside the
    parent's on the same operands, in turns; {} without."""
    if not PARENT:
        return {}
    frag = cf.fragment_order(cf.limbs_bf16(pm, G))
    o, o_p = torch.empty_like(pm), torch.empty_like(pm)
    fn, n = _build.load_library().nb_force_fast, pm.shape[0]
    return vs_parent(f"{tag} force_fast, the launch alone",
                     lambda: launch("force_fast", dev, fn, pm, pm, frag, o, n, n, EPS2, *cf.SELF_DIAG),
                     lambda: _parent_call(PARENT["lib"].nb_force_fast, pm, pm, frag, o_p, n, n, EPS2, *cf.SELF_DIAG),
                     reps=reps)


def _fast_times(dev, pm: torch.Tensor, reps: int) -> dict[str, float]:
    """``force_fast(pm, pm)``'s launch alone (the limb matrix made once,
    outside the events), the whole wrapper, and ``force_exact``."""
    frag = cf.fragment_order(cf.limbs_bf16(pm, G))
    o = torch.empty_like(pm)
    fn = _build.load_library().nb_force_fast
    n = pm.shape[0]
    kernel = lambda: launch("force_fast", dev, fn, pm, pm, frag, o, n, n, EPS2, *cf.SELF_DIAG)  # noqa: E731
    return {"kernel": cuda_ms(kernel, reps=reps),
            "wrapper": cuda_ms(lambda: cf.force_fast(pm, pm, G, EPS2), reps=reps),
            "exact": cuda_ms(lambda: cf.force_exact(pm, pm, G, EPS2), reps=reps)}


# ------------------------------------------------------ the periodic box
PERIODIC = "nbody3d_tpu/ops/"
# The periodic forms: the TPU kernels' periodic branches.
PERIODIC_REPLACES = {
    "short_range": PERIODIC + "p3m.py:730",  # the minimum image :730-735, k_short_periodic :748-755
    "mesh_deposit": PERIODIC + "mesh_pallas.py:270",  # the zmod wrap of _deposit_kernel
    "mesh_gather": PERIODIC + "mesh_pallas.py:315",  # the zmod wrap of _gather_kernel
}
# FP32 FLOP a live-slot pair of the periodic short_range: the isolated 47
# less the A-S erfc's 16, plus the minimum image's 6 selected adds, erff's
# polynomial (about 20; below u = 0.5 k_long's series of 18 takes its place,
# csrc/periodic.cuh) and 3 more in 1/s^3 - erf(u)/r^3 + c2 e/r^2; MUFU
# results: two rsqrt and the ex2 of expf (erff's own ex2 for u > 1 is not
# counted, so the bound is a least time).
FLOP["short_range_periodic"] = 60
SR_MUFU_PERIODIC = 3
# 12b's and 12d's box: benchmarks/p3m_bench.py --boundary periodic (uniform
# box, N = 2,097,152, box 10, grid 128, k = 32: p3m_bench.py:39-56, 109-116).
BOX_N = 2_097_152
BOX_L = 10.0
PERIODIC_SIMS: dict[str, Simulation] = {}  # 12b's and 12d's simulations, for the checks after their windows
PERIODIC_MS: dict[str, float] = {}  # 12b's and 12d's ms/step, beside 15b's comoving cells


def _box_rows(n: int, n_pad: int, dev, seed: int = 0) -> torch.Tensor:
    """``n`` bodies uniform in the unit box (masses U(1, 3)), eight on the
    seams (one in the far corner, whose stencil wraps onto the first and
    the last cell, 3.5e-3 from the padding rows at the origin: a much
    closer pair cancels 1/s^3 - 1/r^3 to nothing in f32), zero-padded to
    ``n_pad`` rows and Morton-sorted as ``accel_p3m`` sorts them."""
    return _sort_box(_box_np(n, seed), n, n_pad, dev)[0]


def _box_np(n: int, seed: int) -> np.ndarray:
    """:func:`_box_rows`' bodies, unsorted and unpadded, in float64."""
    rng = np.random.default_rng(seed)
    pm_np = np.concatenate([rng.uniform(0, 1, (n, 3)), rng.uniform(1.0, 3.0, (n, 1))], axis=1)
    pm_np[:8, :3] = [[0.0, 0.5, 0.0], [1 - 1e-7, 0.5, 0.5], [0.5, 0.0, 1 - 1e-7], [1 - 2e-3, 1 - 2e-3, 1 - 2e-3],
                     [1e-7, 0.25, 0.75], [0.75, 1e-7, 1 - 1e-7], [0.5, 0.5, 0.0], [1 - 2e-7, 2e-7, 0.3]]
    return pm_np


def _sort_box(pm_np: np.ndarray, n: int, n_pad: int, dev):
    """``pm_np`` zero-padded to ``n_pad`` rows in f32 on ``dev`` and
    Morton-sorted as ``accel_p3m`` sorts: ``(rows, where)`` with ``where[i]``
    the sorted row of body ``i``."""
    pos_mass = torch.from_numpy(np.pad(pm_np, ((0, n_pad - n), (0, 0))).astype(np.float32)).to(dev)
    order = torch.argsort(p3m.morton_keys(pos_mass, n), stable=True)
    where = torch.empty_like(order)
    where[order] = torch.arange(n_pad, device=dev)
    return pos_mass[order].contiguous(), where


def _periodic_inputs(ps: torch.Tensor, n_real: int, grid: int, block: int, L: float, nbr_k: int = 32):
    """What the periodic ``accel_p3m`` hands ``short_range`` for the
    wrapped, sorted rows ``ps``: the scales and the neighbour lists."""
    Lt, h, sigma, rcut = (t.to(ps.device) for t in p3m.periodic_scales(grid, L, p3m.DEFAULT_SIGMA_CELLS,
                                                                        p3m.DEFAULT_RCUT_SIGMAS))
    lo_b, hi_b = p3m._sorted_aabbs(ps, n_real, block)
    kth, neg, idx = p3m._select_neighbors(lo_b, hi_b, h, min(nbr_k, ps.shape[0] // block), L=Lt)
    return dict(L=Lt, h=h, sigma=sigma, rcut=rcut, nbr_idx=idx, mask=p3m.mutual_neighbor_mask(neg, idx, kth))


def _periodic_cells(pos_mass: torch.Tensor, h: torch.Tensor, grid: int, order: int):
    """The mesh kernels' operands ``(c4, fm)`` on the torus (TSC at order
    3, CIC at 2) of wrapped rows."""
    cells = p3m._tsc_cells if order == 3 else pm._cic_cells
    lo = torch.zeros(3, device=pos_mass.device)
    return mc.mesh_operands(*cells(pos_mass[:, :3], lo, h, grid, periodic=True), pos_mass[:, 3])


def phase_periodic_checks(dev) -> None:
    """12a: the periodic forms of the three mesh kernels against their plain
    twins on the card, on the unit box with bodies on the seams, at N =
    8,192 and 7,936 (192 padding rows), tiles 128 and 256, grids 32 and
    128, TSC and CIC: the deposit against f64 sums of its terms (each cell
    within its f32 summation bound, exact terms bit for bit, the first and
    last cells written), the gather within 1e-5 of the max, ``short_range``
    (rtol 2e-4, atol 3e-6 of the max) against its twin and against the twin
    run in f64, also with slots masked."""
    print("[12a periodic] short_range, mesh_deposit, mesh_gather periodic forms vs plain twins", flush=True)
    for n_pad, block in ((8192, 128), (8192, 256), (7936, 256)):
        n_real = n_pad - 192
        ps = _box_rows(n_real, n_pad, dev)
        for grid in (32, 128):
            tag = f"periodic N={n_pad} block={block} grid={grid}"
            x = _periodic_inputs(ps, n_real, grid, block, 1.0)
            for order in (3, 2):
                c4, fm = _periodic_cells(ps, x["h"], grid, order)
                rho, rho_p = mc.deposit(c4, fm, grid, order, True), mc.deposit_plain(c4, fm, grid, order, True)
                _deposit_agrees(f"{tag} order {order}", c4, fm, grid, order, rho, rho_p, periodic=True, seam=True)
                grids = ewald.spectral_accel_grids(rho_p, x["L"], x["sigma"], order=order)
                _gather_agrees(tag, grids, c4, fm, grid, order, True)
            mask = x["mask"].clone()
            mask[::3, 1] = 0.0
            args = (ps, x["nbr_idx"], EPS2, x["sigma"], x["rcut"], block)
            args64 = (ps.double(), x["nbr_idx"], EPS2, x["sigma"].double(), x["rcut"].double(), block)
            for what, m in (("mutual mask", x["mask"]), ("mask with slots zeroed", mask)):
                got = p3m.short_range_tiles(*args, m, box=1.0)
                want = p3m.short_range_tiles(*args, m, backend="jnp", box=1.0)
                f64 = p3m._short_range_tiles(*args64, m.double(), box=1.0)
                torch.cuda.synchronize()
                ok, err = _sr_agree(got, want)
                ok64, err64 = _sr_agree(got.double(), f64)
                check(ok and ok64 and not got[:, 3].any(),
                      f"{tag}: periodic short_range ({what}, {int((m == 0).sum())} slots off) rtol 2e-4, atol "
                      f"3e-6 of max against the twin (max-abs/max {err:.3e}) and the f64 sum ({err64:.3e})")
                if PARENT:
                    check(torch.equal(got, parent_short_range(*args, m, box=1.0)),
                          f"{tag}: periodic short_range ({what}) bit-equal to the parent's kernel")
    planted_short_range_checks(dev, periodic=True)
    _deposit_adversarial_checks(dev, periodic=True)
    _gather_box_checks(dev, periodic=True)
    _gather_large_grid_checks(dev)


def _box_run(dev, tag: str, method: str, chunks: int, chunk: int, **cfg):
    """p3m_bench's periodic box (uniform-box, N = 2,097,152, box 10, grid
    128) through ``Simulation``: 30 warm steps with the momentum gate, then
    the timed chunks (:func:`_mesh_run`)."""
    torch.cuda.reset_peak_memory_stats()
    config = SimConfig(method=method, pm_grid=128, p3m_nbr_k=32, boundary="periodic", box_size=BOX_L, **cfg)
    sim = Simulation.from_preset("uniform-box", config, n=BOX_N, box_size=BOX_L, device=dev)
    PERIODIC_MS[tag] = _mesh_run(sim, f"{tag} uniform-box N={sim.n_real} box {BOX_L:g} grid 128"
                                 + (" k 32" if method == "p3m" else "")
                                 + (" interlaced" if cfg.get("mesh_interlace") else ""), chunks=chunks, chunk=chunk)
    PERIODIC_SIMS[tag] = sim
    return [(f"{tag} one step", lambda: sim.run(1, chunk=1))]


def phase_periodic_p3m(dev):
    """12b: periodic P3M at p3m_bench's periodic configuration, 2 timed
    chunks of 10."""
    return _box_run(dev, "[12b periodic p3m]", "p3m", 2, 10)


def phase_periodic_p3m_interlaced(dev):
    """12b with ``--interlace`` (two mesh legs a step)."""
    return _box_run(dev, "[12b periodic p3m interlaced]", "p3m", 2, 10, mesh_interlace=True)


def phase_periodic_pm(dev):
    """12d: periodic PM (CIC) at the same box, 5 timed chunks of 50."""
    return _box_run(dev, "[12d periodic pm]", "pm", 5, 50)


def _ewald_errors(pos_mass: torch.Tensor, acc: torch.Tensor, rows: torch.Tensor, L: float, sigma: float,
                  eps2: float, n_images: int) -> np.ndarray:
    """Per-body relative error of ``acc`` (per unit G, at ``rows``) against
    the f64 Ewald oracle, ``kmax`` as tests/test_periodic.py sets it."""
    kmax = max(10, int(5.5 * L / (2 * np.pi * sigma)) + 1)
    ref = ewald.ewald_accel_reference(pos_mass.double(), L, sigma, eps2=eps2, n_images=n_images, kmax=kmax,
                                      rows=rows, pair_batch=1 << 25)
    return (torch.linalg.norm(acc.double() - ref, dim=1) / torch.linalg.norm(ref, dim=1).clamp(min=1e-300)).cpu().numpy()


def _box_fault(sim: Simulation, samples: int = 2048, label: str = "12b") -> None:
    """12b's inherited ``nbr_k`` fault, reported and not gated: the force
    of ``samples`` sampled bodies against the f64 Ewald oracle (its split
    width L/16 and the minimum image alone: past it erfc(5.66) = 1.6e-15),
    the tile overflow and the quantiles of each tile's count of tiles
    within rcut (k = 32 covers a tile only if that count is <= 32)."""
    from nbody3d_tpu_torch.ops.step import make_mesh_accel_fn

    cfg, pos_mass = sim.config, sim.state.pos_mass
    rows = torch.from_numpy(np.random.default_rng(0).choice(sim.n_real, samples, replace=False)).to(pos_mass.device)
    acc = make_mesh_accel_fn(cfg, sim.n_real, "kernels")(pos_mass, 1.0)[rows, :3]
    t0 = time.perf_counter()
    rel = _ewald_errors(pos_mass, acc, rows, BOX_L, BOX_L / 16, cfg.eps2, 0)
    oracle_s = time.perf_counter() - t0
    within = p3m.tiles_within_rcut(pos_mass, grid=cfg.pm_grid, n_real=sim.n_real, box_size=BOX_L).float()
    ov = p3m.p3m_neighbor_overflow(pos_mass, grid=cfg.pm_grid, n_real=sim.n_real, nbr_k=cfg.p3m_nbr_k,
                                   box_size=BOX_L)
    q = torch.quantile(within, torch.tensor([0.0, 0.5, 0.99, 1.0], device=within.device)).tolist()
    print(f"[{label} inherited nbr_k fault{' interlaced' if cfg.mesh_interlace else ''}] N={sim.n_real}, {samples} "
          f"sampled bodies against the f64 Ewald oracle ({oracle_s:.1f} s): median {np.median(rel):.3e}, p99 "
          f"{np.percentile(rel, 99):.3e}, max {rel.max():.3e}; tile overflow {ov} of {within.numel()} at k = "
          f"{cfg.p3m_nbr_k}; tiles within rcut min {q[0]:.0f}, median {q[1]:.0f}, p99 {q[2]:.0f}, max {q[3]:.0f}",
          flush=True)
    check(bool(np.isfinite(rel).all()), f"[{label}] the sampled forces are finite (accuracy not gated: ROADMAP queue 3)")


def phase_periodic_times(dev) -> dict[str, dict]:
    """After 12b's and 12d's windows: 12b's fault report (both runs), the
    three kernels' periodic forms at 12b's shape and data beside their
    twins, bounds and (deposit) ``index_add_``, then 12d's net force and its
    CIC kernels against their twins."""
    print("[12b periodic] kernel times at the periodic P3M path's shape (CUDA events; plain: host clock, one run)",
          flush=True)
    for tag in ("[12b periodic p3m]", "[12b periodic p3m interlaced]"):
        _box_fault(PERIODIC_SIMS[tag])
    sim = PERIODIC_SIMS.pop("[12b periodic p3m]")
    del PERIODIC_SIMS["[12b periodic p3m interlaced]"]
    grid, block = sim.config.pm_grid, p3m.DEFAULT_BLOCK
    pos = ewald.wrap_box(sim.state.pos_mass[:, :3], BOX_L)
    pm_w = torch.cat([pos, sim.state.pos_mass[:, 3:]], 1)
    ps = pm_w[torch.argsort(p3m.morton_keys(pm_w, sim.n_real), stable=True)].contiguous()
    x = _periodic_inputs(ps, sim.n_real, grid, block, BOX_L)
    del sim
    (c4, fm), n = _periodic_cells(ps, x["h"], grid, 3), ps.shape[0]
    out: dict[str, dict] = {}

    out["mesh_deposit"] = _deposit_row(f"2M periodic P3M (TSC, N={n})", c4, fm, grid, 3, periodic=True)
    rho = mc.deposit(c4, fm, grid, 3, True)
    grids = ewald.spectral_accel_grids(rho, x["L"], x["sigma"], order=3)
    acc = mc.gather(grids, c4, fm, grid, 3, True)
    acc_p = None

    def run_gat_plain():
        nonlocal acc_p
        acc_p = mc.gather_plain(grids, c4, fm, grid, 3, True)

    gat_plain_ms = host_ms(run_gat_plain)
    e_acc = rel_err(acc, acc_p)
    check(e_acc < 1e-5, f"2M periodic: mesh_gather vs plain max-abs/max {e_acc:.3e} < 1e-5")
    out["mesh_gather"] = {
        "max_abs_err": max_abs(acc, acc_p), "ms": cuda_ms(lambda: mc.gather(grids, c4, fm, grid, 3, True), reps=20),
        "plain_ms": gat_plain_ms, "library_ms": None, "shape": f"3 x {grid}^3 torus + ({n}, 4) x 2 -> ({n}, 4), TSC",
        "note": "library: none (grid_sample pads with zeros, the border or a reflection, and has no wrap mode; "
                "nor does it take TSC weights); plain: one run, host clock",
        **bound("mesh_gather", n, 48 * n + 12 * grid**3),
        **_gather_row(f"2M periodic P3M (TSC, N={n})", grids, c4, fm, grid, 3, True, True),
    }
    del acc_p

    args = (ps, x["nbr_idx"], EPS2, x["sigma"], x["rcut"], block, x["mask"])
    sr = p3m.short_range_tiles(*args, box=BOX_L)
    sr_p = None

    def run_sr_plain():
        nonlocal sr_p
        sr_p = p3m.short_range_tiles(*args, backend="jnp", box=BOX_L)

    sr_plain_ms = host_ms(run_sr_plain)
    ok, err = _sr_agree(sr, sr_p)
    check(ok, f"2M periodic: short_range vs plain rtol 2e-4, atol 3e-6 of max (max-abs/max {err:.3e})")
    live = int((x["mask"] != 0).sum())
    pairs = live * block * block
    nb, k = x["nbr_idx"].shape
    shares = rcut_shares(ps, x["nbr_idx"], x["mask"], x["rcut"], block, box=BOX_L)
    out["short_range"] = {
        "max_abs_err": max_abs(sr, sr_p), "ms": cuda_ms(lambda: p3m.short_range_tiles(*args, box=BOX_L), reps=5),
        "plain_ms": sr_plain_ms, "library_ms": None,
        "shape": f"({n}, 4) torus, {nb} tiles of {block}, k {k}, {live} live slots",
        "note": f"{pairs:.4e} slot pairs (mask-0 slots skipped), {shares['in_rcut']:.4e} within rcut, "
                f"{shares['voted']:.4e} through the votes; plain: one run, host clock",
        **sr_bound("short_range_periodic", shares, 32 * n + 8 * nb * k, SR_MUFU_PERIODIC),
        **_sr_vs_parent("2M periodic P3M (12b)", sr, args, box=BOX_L),
    }
    del sr_p
    _print_times({k: v for k, v in out.items() if k != "mesh_deposit"})
    out["mesh_deposit"]["cic"], out["mesh_gather"]["cic"] = _periodic_pm_checks(PERIODIC_SIMS.pop("[12d periodic pm]"))
    return out


def _periodic_pm_checks(sim: Simulation) -> dict:
    """12d after its window: the net force below 3e-5 of sum |f|
    (tests/test_periodic.py:145), then its CIC kernels at its shape and data
    against their twins (the deposit as :func:`_deposit_row`, the gather at
    1e-5 of the max) and their times: ``(deposit row, gather's)``."""
    from nbody3d_tpu_torch.ops.step import make_mesh_accel_fn

    pos_mass, grid = sim.state.pos_mass, sim.config.pm_grid
    f = pos_mass[:, 3:4].double() * make_mesh_accel_fn(sim.config, sim.n_real, "kernels")(pos_mass, 1.0)[:, :3].double()
    net = float(f.sum(dim=0).abs().max() / f.abs().sum())
    check(net < 3e-5, f"[12d periodic pm] N={sim.n_real}: net force {net:.3e} < 3e-5 of sum |f|")
    L = torch.tensor(BOX_L, device=pos_mass.device)
    h = L / grid
    c4, fm = _periodic_cells(torch.cat([ewald.wrap_box(pos_mass[:, :3], L), pos_mass[:, 3:]], 1), h, grid, 2)
    dep = _deposit_row(f"2M periodic PM (CIC, N={fm.shape[0]})", c4, fm, grid, 2, periodic=True)
    grids = ewald.spectral_accel_grids(mc.deposit_plain(c4, fm, grid, 2, True), L, 1.5 * h, order=2)
    acc = mc.gather(grids, c4, fm, grid, 2, True, sorted_rows=False)
    e_acc = rel_err(acc, mc.gather_plain(grids, c4, fm, grid, 2, True))
    check(e_acc < 1e-5, f"2M periodic PM (CIC): mesh_gather vs plain max-abs/max {e_acc:.3e} < 1e-5")
    gather_ms = cuda_ms(lambda: mc.gather(grids, c4, fm, grid, 2, True, sorted_rows=False), reps=20)
    print(f"  periodic CIC at 12d's shape ({fm.shape[0]} particles, {grid}^3 torus): mesh_gather "
          f"{gather_ms:.4f} ms", flush=True)
    return dep, {"ms": gather_ms, **_gather_row(f"2M periodic PM (CIC, N={fm.shape[0]})", grids, c4, fm, grid, 2,
                                                True, False)}


def phase_periodic_accuracy(dev) -> None:
    """12c: the accuracy gate.  The README's 32^3 box (uniform-box N =
    32,768, box 1, grid 32, eps2 1e-6) at k = 128, which covers every tile
    (overflow 0), interlace off and on: 2,048 sampled bodies against the
    f64 Ewald oracle, median < 3e-3 and p99 < 2e-2 (tests/test_periodic.py:
    58-59).  Then tests/test_periodic.py:216-239's collapse through the
    CLI (200 steps, |dE|/KE < 1e-2 in the f64 Ewald energy, momentum < 1e-4
    of sum |m v|), and at N = 8,192 the kernel route against the plain
    route (accelerations and a 5-step rollout, rtol 1e-4, atol 1e-5 of the
    scale) for periodic P3M and PM."""
    from nbody3d_tpu_torch.ops.step import make_mesh_accel_fn

    n, grid = 32768, 32
    pm_np, _, _ = make_preset("uniform-box", seed=0, n=n, box_size=1.0)
    pos_mass = torch.from_numpy(pm_np).to(dev)
    kw = dict(grid=grid, nbr_k=128, box_size=1.0)
    ov = p3m.p3m_neighbor_overflow(pos_mass, **kw)
    check(ov == 0, f"[12c periodic accuracy] N={n} grid {grid} k 128: tile overflow {ov} = 0")
    rows = torch.from_numpy(np.random.default_rng(0).choice(n, 2048, replace=False)).to(dev)
    for il in (False, True):
        acc = p3m.accel_p3m(pos_mass, 1.0, eps2=1e-6, boundary="periodic", interlace=il, **kw)[rows, :3]
        rel = _ewald_errors(pos_mass, acc, rows, 1.0, 1.5 / grid, 1e-6, 2)
        med, p99 = float(np.median(rel)), float(np.percentile(rel, 99))
        check(med < 3e-3 and p99 < 2e-2,
              f"[12c periodic accuracy{' interlaced' if il else ''}] N={n} grid {grid} k 128, 2048 sampled bodies "
              f"vs f64 Ewald: median {med:.3e} < 3e-3, p99 {p99:.3e} < 2e-2 (max {rel.max():.3e})")

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["run", "--device", dev.type, "--preset", "uniform-box", "--n", "512", "--method", "p3m",
                "--boundary", "periodic", "--box-size", "1", "--pm-grid", "32", "--p3m-nbr-k", "8", "--dt", "2e-4",
                "--G", "2e-3", "--steps", "200", "--log-every", "50", "--diagnostics", "--outdir", tmp]
        print(f"[12c periodic run] cli {' '.join(argv)}", flush=True)
        cfg = SimConfig(method="p3m", boundary="periodic", box_size=1.0, pm_grid=32, p3m_nbr_k=8, dt=2e-4, G=2e-3)
        d0 = Simulation.from_preset("uniform-box", cfg, n=512, box_size=1.0, device=dev).diagnostics()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        run_s = time.perf_counter() - t0
        sim = Simulation.load(str(pathlib.Path(tmp) / "final.npz"), device=dev)
        d1 = sim.diagnostics()
    p, v, _ = sim.arrays()
    ke = float(d1.kinetic)
    de = abs(float(d1.total_energy) - float(d0.total_energy)) / max(ke, 1e-30)
    mom = float(np.linalg.norm(d1.momentum)) / max(float(np.abs(p[:, 3:4] * v[:, :3]).sum()), 1e-30)
    check(rc == 0 and sim.step_count == 200 and sim.config.boundary == "periodic" and np.isfinite(p).all(),
          f"periodic p3m run rc {rc} in {run_s:.3f} s, step {sim.step_count}, boundary {sim.config.boundary}, finite")
    check(de < 1e-2 and mom < 1e-4 and ke > abs(float(d0.total_energy)),
          f"periodic p3m run: |dE|/KE {de:.3e} < 1e-2 (f64 Ewald energy), momentum {mom:.3e} < 1e-4 of "
          f"sum |m v|, collapsed (KE {ke:.4e} > |E0| {abs(float(d0.total_energy)):.4e})")

    ps = _box_rows(8000, 8192, dev, seed=3)
    vel = torch.zeros_like(ps)
    vel[:8000, :3] = torch.from_numpy(np.random.default_rng(3).normal(scale=0.3, size=(8000, 3))).float().to(dev)
    for method in ("p3m", "pm"):
        cfg = SimConfig(method=method, pm_grid=32, p3m_nbr_k=16, boundary="periodic", box_size=1.0, G=2e-3)
        acc_k = make_mesh_accel_fn(cfg, 8000, "kernels")(ps, cfg.G)
        acc_p = make_mesh_accel_fn(cfg, 8000, "plain")(ps, cfg.G)
        states = {}
        for route, c in (("kernels", cfg), ("jnp", cfg.replace(backend="jnp"))):
            step = make_step_fn(c, 8192, 8000, dev)
            st = SimState(ps.clone(), vel.clone(), torch.zeros_like(ps), 0)
            for _ in range(5):
                st = step(st, 2e-4, cfg.G)
            states[route] = st
        torch.cuda.synchronize()
        for what, a, b in (("accel", acc_k, acc_p),
                           ("5-step positions", states["kernels"].pos_mass, states["jnp"].pos_mass),
                           ("5-step velocities", states["kernels"].vel, states["jnp"].vel)):
            a, b = a[:8000, :3], b[:8000, :3]
            scale = float(b.abs().max())
            excess = float(((a - b).abs() - 1e-4 * b.abs()).max())
            check(excess <= 1e-5 * scale, f"[12c periodic check] N=8192 {method} kernel route vs jnp route, {what}: "
                  f"worst |diff| - 1e-4|ref| = {excess:.3e} <= {1e-5 * scale:.3e}")


# ------------------------------------------------ the periodic gradient
PERIODIC_REPLACES["short_range_bwd"] = PERIODIC + "p3m.py:913"  # the minimum image :913-918, k' and k_s :938-953
# FP32 FLOP a live-slot pair of the periodic short_range_bwd and its MUFU
# results (csrc/short_range_bwd.cu's source note): two rsqrt, the ex2 of
# expf, the rcp of 1/(r + s), erfcf's ex2 and rcp (erff's ex2 for u > 1 not
# counted, so the bound is a least time).
FLOP["short_range_bwd_periodic"] = 180
SR_BWD_MUFU_PERIODIC = 6
# 13a's planted pairs: separation, and the axis whose seam each straddles.
PLANTED = ((1e-3, 0), (1e-4, 1), (1e-5, 2))


def _planted_box_rows(n: int, n_pad: int, dev, seed: int = 0):
    """:func:`_box_rows`' scene with three more pairs planted across the
    seams at separations 1e-3, 1e-4 and 1e-5 (rows 8-13 before the sort),
    sorted as ``accel_p3m`` sorts; ``(ps, [(r, row_i, row_j)])`` with the
    pairs' rows in sorted order."""
    pm_np = _box_np(n, seed)
    for p, (r, axis) in enumerate(PLANTED):
        a = np.full(3, 0.3 + 0.2 * p)
        b = a.copy()
        a[axis], b[axis] = r / 2, 1 - r / 2
        pm_np[8 + 2 * p, :3], pm_np[9 + 2 * p, :3] = a, b
    ps, where = _sort_box(pm_np, n, n_pad, dev)
    return ps, [(r, int(where[8 + 2 * p]), int(where[9 + 2 * p])) for p, (r, _) in enumerate(PLANTED)]


def _planted_agree(tag: str, ps, g, got, want64, pairs, sigma: float) -> None:
    """The kernel's x̄ of each planted pair's rows against the twin run in
    f64: within 1e-5 of the row plus 8 ulp of ``s⁻³ + k_long`` (the
    forward's k, which the backward shares, keeps a few ulp of it at any r:
    ``csrc/periodic.cuh`` takes k_long's series below u = 0.5) times
    |m_i g_j - m_j g_i| (rsqrtf is within 2 ulp)."""
    worst = 0.0
    for r, i, j in pairs:
        terms = (r * r + EPS2) ** -1.5 + float(ewald.k_long_gauss(torch.tensor(r * r, dtype=torch.float64), sigma))
        for p, q in ((i, j), (j, i)):
            mg = float(torch.linalg.norm(ps[p, 3] * g[q, :3] - ps[q, 3] * g[p, :3]))
            err = float(torch.linalg.norm(got[p, :3].double() - want64[p, :3]))
            bound = 1e-5 * float(torch.linalg.norm(want64[p, :3])) + 8 * 2.0**-24 * terms * mg
            worst = max(worst, err / bound)
            print(f"    {tag} planted r={r:g} row {p}: |x̄ - f64| {err:.3e} (relative "
                  f"{err / float(torch.linalg.norm(want64[p, :3])):.3e}), bound {bound:.3e}", flush=True)
    check(worst <= 1.0, f"{tag}: periodic short_range_bwd on the planted pairs (r = 1e-3, 1e-4, 1e-5 across the "
          f"seams) vs the twin in f64, worst error / bound {worst:.3e} <= 1")


def _mesh_vjps_agree(tag: str, c4, fm, grid: int, order: int) -> None:
    """``deposit_vjp`` and ``gather_vjp`` with ``periodic=True`` on the card
    against autograd through their twins (``deposit_plain``,
    ``gather_plain``), a random cotangent, within 1e-5 of the max; then the
    gather's grid cotangent (three periodic ``mesh_deposit`` launches) on
    exact terms (f = 1/2, a cotangent of 1 a lane) bit for bit against f64
    sums, the first and last cells written."""
    rng = np.random.default_rng(grid + order)
    rho_bar = torch.from_numpy(rng.standard_normal((grid, grid, grid)).astype(np.float32)).to(fm.device)
    out_bar = torch.from_numpy(rng.standard_normal((fm.shape[0], 4)).astype(np.float32)).to(fm.device)
    grids = torch.from_numpy(rng.standard_normal((3, grid**3)).astype(np.float32)).to(fm.device)
    got_d = mc.deposit_vjp(c4, fm, rho_bar, grid, order, periodic=True)
    f_ = fm.clone().requires_grad_()
    want_d, = torch.autograd.grad(mc.deposit_plain(c4, f_, grid, order, periodic=True), f_, rho_bar)
    got_g, got_f = mc.gather_vjp(grids, c4, fm, out_bar, grid, order, periodic=True)
    g_, f_ = grids.clone().requires_grad_(), fm.clone().requires_grad_()
    want_g, want_f = torch.autograd.grad(mc.gather_plain(g_, c4, f_, grid, order, periodic=True), (g_, f_),
                                         torch.cat([out_bar[:, :3], torch.zeros_like(out_bar[:, :1])], 1))
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in ((got_d, want_d), (got_g, want_g), (got_f, want_f))]
    check(max(errs) < 1e-5, f"{tag}: periodic deposit_vjp (fm̄ {errs[0]:.3e}) and gather_vjp (grids̄ {errs[1]:.3e}, "
          f"fm̄ {errs[2]:.3e}) vs autograd through the twins, max-abs/max < 1e-5")
    exact = fm.clone()
    exact[:, :3] = 0.5
    ones = torch.ones_like(out_bar)
    gbar, _ = mc.gather_vjp(grids, c4, exact, ones, grid, order, periodic=True)
    want = mc.deposit_plain(c4, torch.cat([exact[:, :3].double(), ones[:, :1].double()], 1), grid, order,
                            periodic=True).view(-1)
    ok = all(torch.equal(gbar[i].double(), want) for i in range(3))
    check(ok and float(gbar[0, 0] * gbar[0, -1]) > 0,
          f"{tag}: periodic gather_vjp's grid cotangent on exact terms equal to f64 sums in every cell of the 3 "
          f"grids, first cell {float(gbar[0, 0]):.3f}, last cell {float(gbar[0, -1]):.3f}")


def phase_periodic_grad_checks(dev) -> None:
    """13a: the periodic ``short_range_bwd`` against its twin on the card on
    12a's unit box with three pairs planted across the seams (r = 1e-3, 1e-4,
    1e-5), at N = 8,192 and 7,936, tiles 128 and 256, grids 32 and 128, with
    tile 3 massless and slots killed in mutual pairs, for a random
    cotangent (``_bwd_agrees``), and on the planted pairs against the twin
    in f64; the periodic mesh VJPs against autograd through the twins at
    TSC and CIC, grids 32 and 128; then ``short_range_bwd`` on
    ``pair_checks``' periodic planted scenes (a warp astride the k' switch
    among them); with ``--parent`` each bit-equal to the parent's kernel."""
    print("[13a periodic grad] short_range_bwd periodic form, periodic mesh VJPs vs plain twins", flush=True)
    for n_pad, block in ((8192, 128), (8192, 256), (7936, 256)):
        n_real = n_pad - 192
        ps0, pairs = _planted_box_rows(n_real, n_pad, dev)
        for grid in (32, 128):
            tag = f"periodic N={n_pad} block={block} grid={grid}"
            x = _periodic_inputs(ps0, n_real, grid, block, 1.0)
            ps = ps0.clone()
            ps[3 * block : 4 * block, 3] = 0.0
            mask = _mutual_kills(x["mask"], x["nbr_idx"])
            g = _random_cotangent(n_pad, dev, 13)
            args = (ps, g, x["nbr_idx"], EPS2, x["sigma"], x["rcut"], block, mask)
            got = p3m.short_range_tiles_bwd(*args, box=1.0)
            want = p3m.short_range_tiles_bwd(*args, backend="jnp", box=1.0)
            torch.cuda.synchronize()
            sub = f"{tag} ({int((mask == 0).sum())} slots off, tile 3 massless)"
            _bwd_agrees(sub, got, want)
            _bwd_parent_equal(sub, got, args, 1.0)
            check(float(got[0][3 * block : 4 * block, 3].abs().max()) > 0,
                  f"{sub}: the massless tile's rows get a mass cotangent")
            # The planted pairs under the mutual mask alone (the kills above may drop their slots).
            args = (ps, g, x["nbr_idx"], EPS2, x["sigma"], x["rcut"], block, x["mask"])
            got = p3m.short_range_tiles_bwd(*args, box=1.0)
            want64 = p3m._short_range_tiles_bwd(ps.double(), g.double(), x["nbr_idx"], EPS2, x["sigma"].double(),
                                                x["rcut"].double(), block, x["mask"].double(), box=1.0)
            live = [i // block == j // block or bool(((x["nbr_idx"][i // block] == j // block)
                                                        & (x["mask"][i // block] > 0)).any()) for _, i, j in pairs]
            check(all(live), f"{tag}: every planted pair's tiles list each other under the mutual mask")
            _planted_agree(tag, ps, g, got[0], want64[0], pairs, float(x["sigma"]))
            _bwd_parent_equal(f"{tag} (planted pairs)", got, args, 1.0)
            for order in (3, 2):
                c4, fm = _periodic_cells(ps0, x["h"], grid, order)
                _mesh_vjps_agree(f"{tag} order {order}", c4, fm, grid, order)
    planted_short_range_bwd_checks(dev, periodic=True)


def phase_periodic_grad_p3m(dev):
    """13b: the periodic P3M gradient at p3m_bench's periodic box (uniform
    box, N = 2,097,152, box 10, grid 128, k = 32), grad_bench's rollout."""
    return _grad_path(dev, "p3m", "[13b periodic grad p3m]", "uniform-box", boundary="periodic", box_size=BOX_L)


def phase_periodic_grad_p3m_interlaced(dev):
    """13b with ``--interlace``."""
    return _grad_path(dev, "p3m", "[13b periodic grad p3m interlaced]", "uniform-box", boundary="periodic",
                      box_size=BOX_L, mesh_interlace=True)


def phase_periodic_grad_pm(dev):
    """13c: the periodic PM gradient (CIC, grid 128) at 13b's box."""
    return _grad_path(dev, "pm", "[13c periodic grad pm]", "uniform-box", boundary="periodic", box_size=BOX_L)


def phase_periodic_grad_times(dev) -> dict[str, dict]:
    """After 13b's windows: the periodic ``short_range_bwd`` at 13b's shape
    and data (the rollout's first bodies, wrapped, sorted and selected as
    the periodic ``accel_p3m`` does) beside its twin, for a random
    cotangent."""
    print("[13b periodic grad] short_range_bwd periodic at the periodic P3M gradient path's shape (CUDA events; "
          "plain: host clock, one run)", flush=True)
    pos_mass = GRAD_2M.pop("[13b periodic grad p3m]")
    for tag in ("[13b periodic grad p3m interlaced]", "[13c periodic grad pm]"):
        GRAD_2M.pop(tag)
    n, grid, block = pos_mass.shape[0], 128, p3m.DEFAULT_BLOCK
    pm_w = torch.cat([ewald.wrap_box(pos_mass[:, :3], BOX_L), pos_mass[:, 3:]], 1)
    ps = pm_w[torch.argsort(p3m.morton_keys(pm_w, n), stable=True)].contiguous()
    x = _periodic_inputs(ps, n, grid, block, BOX_L)
    args = (ps, _random_cotangent(n, dev, 14), x["nbr_idx"], EPS2, x["sigma"], x["rcut"], block, x["mask"])
    got = p3m.short_range_tiles_bwd(*args, box=BOX_L)
    want = None

    def run_plain():
        nonlocal want
        want = p3m.short_range_tiles_bwd(*args, backend="jnp", box=BOX_L)

    plain_ms = host_ms(run_plain)
    _bwd_agrees(f"2M periodic uniform box (N={n})", got, want)
    live = int((x["mask"] != 0).sum())
    nb, k = x["nbr_idx"].shape
    shares = rcut_shares(ps, x["nbr_idx"], x["mask"], x["rcut"], block, box=BOX_L)
    r = {
        "max_abs_err": max_abs(got[0], want[0]),
        "ms": cuda_ms(lambda: p3m.short_range_tiles_bwd(*args, box=BOX_L), reps=3),
        "plain_ms": plain_ms, "library_ms": None,
        "shape": f"({n}, 4) x 2 torus, {nb} tiles of {block}, k {k}, {live} live slots",
        "note": f"{shares['pairs']:.4e} slot pairs (mask-0 slots skipped); plain: one run, host clock",
        **sr_bound("short_range_bwd_periodic", shares, 52 * n + 8 * nb * k, SR_BWD_MUFU_PERIODIC),
        **_bwd_vs_parent("2M periodic uniform box (13b)", got, args, box=BOX_L),
    }
    print(f"  short_range_bwd periodic {r['shape']:48s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  max-abs err {r['max_abs_err']:.3e}" + _extras(r)
          + f"  [{r['note']}]", flush=True)
    return {"short_range_bwd": r}


def phase_periodic_grad_crosscheck(dev) -> None:
    """13d: at N = 8,192 (12c's box scene: seam bodies, random velocities)
    the kernel route's 5-step rollout gradient against the
    ``backend="jnp"`` route's (the twins, autograd through the mesh twins),
    periodic P3M with interlace off and on and periodic PM, by v0 and by dt
    and G (0-d tensors): rtol 2e-3, 9d's bound."""
    ps = _box_rows(8000, 8192, dev, seed=3)
    vel = torch.zeros_like(ps)
    vel[:8000, :3] = torch.from_numpy(np.random.default_rng(3).normal(scale=0.3, size=(8000, 3))).float().to(dev)
    for method, il in (("p3m", False), ("p3m", True), ("pm", False)):
        what = f"[13d periodic grad check] N=8192 {method}{' interlaced' if il else ''}"
        cfg = SimConfig(method=method, pm_grid=32, p3m_nbr_k=16, boundary="periodic", box_size=1.0,
                        mesh_interlace=il)
        grads = {}
        for route, c in (("kernels", cfg), ("jnp", cfg.replace(backend="jnp"))):
            step = make_step_fn(c, 8192, 8000, dev)
            v = vel.clone().requires_grad_()
            dt, g = (torch.tensor(x, device=dev, requires_grad=True) for x in (2e-4, 2e-3))
            s = SimState(ps.clone(), v, torch.zeros_like(ps), 0)
            for _ in range(5):
                s = step(s, dt, g)
            loss = (s.pos_mass[:8000, :3] ** 2).sum() / 8000 + (s.vel[:8000, :3] ** 2).sum()
            grads[route] = torch.autograd.grad(loss, (v, dt, g))
        (gv, gdt, gg), (rv, rdt, rg) = grads["kernels"], grads["jnp"]
        _grad_agrees(gv, rv, f"{what} kernel route vs jnp route, by v0")
        e_dt, e_g = (abs(float(a) - float(b)) / abs(float(b)) for a, b in ((gdt, rdt), (gg, rg)))
        check(e_dt <= 2e-3 and e_g <= 2e-3,
              f"{what}: d/d dt {float(gdt):.6e} (rel err {e_dt:.3e}), d/dG {float(gg):.6e} (rel err {e_g:.3e}) "
              f"vs jnp route, rtol 2e-3")


# ------------------------------------------------ the macro-tiled sym schedule
# pair_sym's FP32 FLOP a pair (csrc/pair_sym.cu's source note): sym_hops's.
FLOP["pair_sym"] = 25
# 14b: benchmarks/scale_sweep.py's top rung (uniform sphere, N = 2,097,152,
# force_mode="sym", morton_every=64, 1-step chunks), above MACRO_MIN_N.
MACRO_N = 2_097_152
MACRO_SIMS: dict[str, Simulation] = {}  # 14b's simulation, for the checks after the windows
# 14c: the twin's reduced shape (the kernel's is a chunk pair of 14b).
PAIR_PLAIN_ROWS = 131_072


def _pair_momentum(tgt, src, acc_t, acc_s) -> float:
    """``|sum m a|`` over both sets over ``sum m |a|``: Newton-3 leaves the
    f32 rounding of the rows."""
    mt, ms = tgt[:, 3:4].double(), src[:, 3:4].double()
    p = (mt * acc_t.double()).sum(0) + (ms * acc_s.double()).sum(0)
    scale = (mt * acc_t.double().norm(dim=1, keepdim=True)).sum() + (ms * acc_s.double().norm(dim=1, keepdim=True)).sum()
    return float(p.abs().max() / scale)


def phase_macro_checks(dev) -> None:
    """14a: ``pair_sym`` against its plain twin on the card at Nt x Ns =
    8,192 x 7,936, 512 x 256 and 256 x 256, tiles 128 and 256, padded rows
    on both sides and a 1e7 body (among the targets at tile 128, the
    sources at 256): both outputs < 2e-5 of scale, w lanes 0, the momentum
    balance printed; then ``accel_sym_macro`` at N = 8,192 with 4 chunks
    against ``accel_sym``, < 2e-5 of scale."""
    print("[14a macro sym] pair_sym vs plain twin, accel_sym_macro vs accel_sym", flush=True)
    rng = np.random.default_rng(14)
    for nt_rows, ns_rows in ((8192, 7936), (512, 256), (256, 256)):
        for b in (128, 256):
            tgt = _inputs(rng, nt_rows, nt_rows - 100, dev)[0]
            src = _inputs(rng, ns_rows, ns_rows - 60, dev)[0]
            src[:, :3] += 0.5  # disjoint sets: the padded rows do not coincide
            (tgt if b == 128 else src)[0, 3] = 1e7
            acc_t, acc_s = cf.accel_pair_sym(tgt, src, G, eps2=EPS2, b=b)
            want_t, want_s = cf.accel_pair_sym_plain(tgt, src, G, eps2=EPS2, b=b)
            torch.cuda.synchronize()
            e_t, e_s = rel_err(acc_t, want_t), rel_err(acc_s, want_s)
            lanes = not acc_t[:, 3].any() and not acc_s[:, 3].any()
            check(e_t < 2e-5 and e_s < 2e-5 and lanes,
                  f"Nt x Ns = {nt_rows} x {ns_rows} tile {b}: pair_sym vs plain max-abs/scale targets {e_t:.3e}, "
                  f"sources {e_s:.3e} < 2e-5, w lanes 0; momentum |sum m a| / sum m|a| kernel "
                  f"{_pair_momentum(tgt, src, acc_t, acc_s):.3e}, twin {_pair_momentum(tgt, src, want_t, want_s):.3e}")
    # Source tile counts whose runs are cut short (SYM_RUN = 8): 9 = 8 + 1,
    # 17 (odd) = 8 + 8 + 1, 2 (one short run); 1e7 bodies on both sides;
    # eps2 = 1e-14 (subnormal eps2^3: rsqrtf with its guard); a tile of 1024
    # rows (shared memory above 48 KB).
    for nt, ns, b, eps2 in ((3, 9, 256, EPS2), (5, 17, 128, EPS2), (2, 2, 256, EPS2), (3, 9, 256, 1e-14),
                            (2, 3, 1024, EPS2)):
        tgt = _inputs(rng, nt * b, nt * b - 40, dev)[0]
        src = _inputs(rng, ns * b, ns * b - 24, dev)[0]
        src[:, :3] += 0.5
        tgt[7, 3] = src[ns * b // 2, 3] = 1e7
        acc_t, acc_s = cf.accel_pair_sym(tgt, src, G, eps2=eps2, b=b)
        want_t, want_s = cf.accel_pair_sym_plain(tgt, src, G, eps2=eps2, b=b)
        torch.cuda.synchronize()
        e_t, e_s = rel_err(acc_t, want_t), rel_err(acc_s, want_s)
        lanes = not acc_t[:, 3].any() and not acc_s[:, 3].any()
        check(e_t < 2e-5 and e_s < 2e-5 and lanes,
              f"nt x ns = {nt} x {ns} tiles of {b} eps2 {eps2:g} ({sym_runs(ns)} runs a target tile): pair_sym vs "
              f"plain with 1e7 bodies on both sides, targets {e_t:.3e}, sources {e_s:.3e} < 2e-5, w lanes 0")
    n = 8192
    pm = _inputs(rng, n, n - 192, dev)[0]
    pm[0, 3] = 1e7
    macro = cf.accel_sym_macro(pm, G, eps2=EPS2, b=GPU_TILE, m_chunks=4)
    direct = cf.accel_sym(pm, G, eps2=EPS2, b=GPU_TILE)
    torch.cuda.synchronize()
    e = rel_err(macro, direct)
    check(e < 2e-5 and macro.shape == direct.shape,
          f"N={n}: accel_sym_macro (4 chunks of {n // 4}, tile {GPU_TILE}) vs accel_sym max-abs/scale {e:.3e} < 2e-5")


def phase_macro_sym(dev):
    """14b: scale_sweep's top rung through ``Simulation``: uniform sphere,
    N = 2,097,152, sym, ``morton_every=64``, Verlet (above MACRO_MIN_N: the
    macro-tiled schedule), 1 warm and 5 timed 1-step chunks; ms/step,
    G-int/s, the momentum error over the 6 steps against 1e-5 of the final
    sum |m v| (the sphere starts at rest), and the launches a step."""
    cfg = SimConfig(force_mode="sym", morton_every=64)
    sim = Simulation.from_preset("uniform-sphere", cfg, n=MACRO_N, device=dev)
    MACRO_SIMS["14b"] = sim
    p0 = _momentum(sim)
    warm = _timed_chunks(sim, 1, 1)
    times = _timed_chunks(sim, 5, 1)
    pscale = float((sim.state.pos_mass[:, 3:4].double() * sim.state.vel[:, :3].double()).abs().sum())
    mom = float((_momentum(sim) - p0).abs().max()) / pscale
    med = statistics.median(times)
    finite = bool(torch.isfinite(sim.state.pos_mass).all() and torch.isfinite(sim.state.vel).all())
    m = macro_chunks(sim.n_pad)
    print(f"[14b macro sym] uniform-sphere N={sim.n_real} sym morton_every=64 verlet, {m} chunks of "
          f"{sim.n_pad // m}: median of 5 one-step chunks {med * 1e3:.4f} ms/step, "
          f"{sim.pair_interactions_per_step / med / 1e9:.2f} G-int/s; warm {warm[0]:.4f} s, timed "
          f"{[round(t, 4) for t in times]}; momentum err {mom:.3e} of sum |m v| {pscale:.4e} after 6 steps; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(finite and sim.state.pos_mass.shape == (sim.n_pad, 4), "14b: finite state of shape (n_pad, 4)")
    check(mom <= 1e-5, f"14b: momentum error over 6 steps {mom:.3e} <= 1e-5")
    nt = sim.n_pad // m // GPU_TILE
    per_step = {"sym_diag_prep": m, "sym_hops": m * len(split_hops(nt)), "sym_combine": m,
                "pair_sym": m * (m - 1) // 2}
    got = {k: c for k, c in launch_counts().items() if c}
    check(got == {k: 6 * c for k, c in per_step.items()},
          f"14b: each step launched {per_step} (split_hops({nt}) is {len(split_hops(nt))} sym_hops launches a "
          f"chunk) and no other kernel: {got} over 6 steps")
    return [("14b one macro sym step", lambda: sim.run(1, chunk=1))]


def _accel_f64_card(pm: torch.Tensor, rows: torch.Tensor, g: float, eps2: float, chunk: int = 32) -> torch.Tensor:
    """The accelerations of ``rows`` by an f64 sum over every row of
    ``pm`` on the card: ``(len(rows), 3)``."""
    p = pm.double()
    out = []
    for s in range(0, rows.shape[0], chunk):
        t = p[rows[s : s + chunk]]
        d = p[None, :, :3] - t[:, None, :3]
        w = g * p[None, :, 3] * (torch.sum(d * d, dim=-1) + eps2) ** -1.5
        out.append(torch.einsum("ij,ijc->ic", w, d))
    return torch.cat(out)


def phase_macro_times(dev) -> dict[str, dict]:
    """After the windows, on 14b's state: the macro force and the direct
    ``accel_sym`` (8,192 tiles) on 2,048 sampled rows against an f64 sum on
    the card (the macro's max-abs/scale no worse than 2x the direct's +
    1e-6), one call of each by host clock; then (14c) ``pair_sym`` on a
    chunk pair (524,288 x 524,288) by CUDA events beside its FP32 bound,
    and against its twin at a reduced 131,072 x 131,072 (the twin's one
    run by host clock)."""
    print("[14c macro sym] accuracy at 2M and pair_sym's time", flush=True)
    sim = MACRO_SIMS["14b"]
    pm, g, eps2 = sim.state.pos_mass, sim.G, sim.config.eps2
    n = sim.n_pad
    m = macro_chunks(n)
    size = n // m
    b = fit_block(size, GPU_TILE)
    rows = torch.from_numpy(np.sort(np.random.default_rng(14).choice(sim.n_real, 2048, replace=False))).to(dev)
    res = {}
    macro_ms = host_ms(lambda: res.setdefault("macro", make_sym_accel_fn(sim.config, n)(pm, g)))
    direct_ms = host_ms(lambda: res.setdefault("direct", cf.accel_sym(pm, g, eps2=eps2, b=GPU_TILE)))
    f64 = _accel_f64_card(pm, rows, g, eps2)
    scale = float(f64.abs().max())
    e_macro, e_direct = (float((res[k][rows, :3].double() - f64).abs().max()) / scale for k in ("macro", "direct"))
    print(f"  N={sim.n_real}: macro force ({m} chunks, tile {b}) {macro_ms:.4f} ms, direct accel_sym "
          f"({n // GPU_TILE} tiles) {direct_ms:.4f} ms (host clock, one call each)", flush=True)
    check(e_macro <= 2 * e_direct + 1e-6,
          f"14b 2,048 sampled rows vs f64 on the card: macro max-abs/scale {e_macro:.3e} <= 2 x direct "
          f"accel_sym's {e_direct:.3e} + 1e-6")
    del res, f64
    tgt, src = pm[:size], pm[size : 2 * size]
    ms = cuda_ms(lambda: cf.accel_pair_sym(tgt, src, g, eps2=eps2, b=b), reps=3)
    k = PAIR_PLAIN_ROWS
    t_s, s_s = pm[:k], pm[size : size + k]
    got = cf.accel_pair_sym(t_s, s_s, g, eps2=eps2, b=b)
    small_ms = cuda_ms(lambda: cf.accel_pair_sym(t_s, s_s, g, eps2=eps2, b=b), reps=3)
    out = {}
    plain_ms = host_ms(lambda: out.setdefault("want", cf.accel_pair_sym_plain(t_s, s_s, g, eps2=eps2, b=b)))
    want = out["want"]
    e_t, e_s = rel_err(got[0], want[0]), rel_err(got[1], want[1])
    check(e_t < 2e-5 and e_s < 2e-5,
          f"pair_sym at ({k}, 4) x ({k}, 4) of 14b's state vs plain max-abs/scale targets {e_t:.3e}, sources "
          f"{e_s:.3e} < 2e-5; momentum |sum m a| / sum m|a| {_pair_momentum(t_s, s_s, *got):.3e}")
    parent = {}
    if PARENT:
        par = parent_pair_sym(t_s, s_s, g, eps2, b)
        e_pt, e_ps = rel_err(par[0], want[0]), rel_err(par[1], want[1])
        check(e_pt < 2e-5 and e_ps < 2e-5,
              f"the parent's pair_sym at ({k}, 4) x ({k}, 4) vs plain targets {e_pt:.3e}, sources {e_ps:.3e} < 2e-5")
        del par
        parent = vs_parent(f"pair_sym ({size}, 4) x ({size}, 4)",
                           lambda: cf.accel_pair_sym(tgt, src, g, eps2=eps2, b=b),
                           lambda: parent_pair_sym(tgt, src, g, eps2, b), reps=3)
    times = {"pair_sym": {
        "max_abs_err": max(max_abs(got[0], want[0]), max_abs(got[1], want[1])),
        "ms": ms,
        "plain_ms": plain_ms,
        "shape": f"({size}, 4) x ({size}, 4), tile {b}",
        "note": f"plain_ms and max_abs_err at ({k}, 4) x ({k}, 4), the twin's one run by host clock; "
                f"kernel there {small_ms:.4f} ms",
        **bound("pair_sym", size * size, 32 * 2 * size, rsqrts=size * size),
        **parent,
    }}
    _print_times(times)
    return times


def phase_macro_grad_crosscheck(dev, n: int = 8192) -> None:
    """14d: at N = 8,192 the kernel route through an explicit 4-chunk
    composition (``make_diff_accel`` over ``accel_sym_macro``: the Newton-3
    VJP kernels in the backward) against the ``backend="jnp"`` route, a
    5-step Verlet rollout's gradient by v0, dt and G, rtol 2e-3."""
    rng = np.random.default_rng(15)
    pm = torch.from_numpy(np.concatenate(
        [rng.standard_normal((n, 3)), rng.uniform(10, 50, (n, 1))], axis=1).astype(np.float32)).to(dev)
    accel = fv.make_diff_accel(lambda p, g: cf.accel_sym_macro(p, g, eps2=EPS2, b=GPU_TILE, m_chunks=4),
                               eps2=EPS2, b=GPU_TILE)

    def macro_step(s, dt, g):
        return integrate_state("verlet", lambda p: accel(p, g), s, dt, n_real=n)

    grads = {}
    for name, step in (("macro", macro_step), ("jnp", make_step_fn(SimConfig(backend="jnp"), n, n, dev))):
        v = torch.zeros((n, 4), device=dev, requires_grad=True)
        dt, g = (torch.tensor(x, device=dev, requires_grad=True) for x in (1e-2, G))
        s = SimState(pm.clone(), v, torch.zeros_like(pm), 0)
        for _ in range(5):
            s = step(s, dt, g)
        grads[name] = torch.autograd.grad((s.pos_mass[0, :3] ** 2).sum(), (v, dt, g))
    (gv, gdt, gg), (rv, rdt, rg) = grads["macro"], grads["jnp"]
    _grad_agrees(gv, rv, f"[14d grad check] N={n} macro sym route (4 chunks) vs jnp route, by v0")
    e_dt, e_g = (abs(float(a) - float(b)) / abs(float(b)) for a, b in ((gdt, rdt), (gg, rg)))
    check(e_dt <= 2e-3 and e_g <= 2e-3,
          f"[14d grad check] N={n} macro sym: d/d dt {float(gdt):.6e} (rel err {e_dt:.3e}), "
          f"d/dG {float(gg):.6e} (rel err {e_g:.3e}) vs jnp route, rtol 2e-3")


# ------------------------------------------------ the cosmological workflow
# Phase 15: the comoving step of ops/expansion.py on the periodic
# mesh force, the cosmo preset, and the analysis layer (analysis.py).
COSMO_L = BOX_L  # 15b's box: p3m_bench's periodic box (12b's N, box and grid)
COSMO_N1 = 128  # 128^3 = 2,097,152 bodies
COSMO_SIMS: dict[str, Simulation] = {}  # 15b's simulations, for 15c and the launch counts after the windows


def _eds_t_i(mass: float, G: float, L: float) -> float:
    """EdS ``t_i = 2 / (3 H_i)``, ``H_i² = 8πGρ̄/3``, ``ρ̄ = mass / L³``
    (the background's start)."""
    return 2.0 / (3.0 * np.sqrt(8.0 * np.pi / 3.0 * G * mass / L**3))


def _cosmo_config(method: str, cosmology: str, grid: int, nbr_k: int, L: float, **kw) -> SimConfig:
    return SimConfig(method=method, pm_grid=grid, p3m_nbr_k=nbr_k, boundary="periodic", box_size=L,
                     cosmology=cosmology, **kw)


def _band_power(pos_mass: torch.Tensor, grid: int, L: float, k_max: float) -> float:
    """tests/test_expansion.py's band power: the mode-weighted mean P(k)
    over the bins with more than 10 modes below ``k_max``."""
    k, p, c = analysis.power_spectrum(pos_mass, grid=grid, box_size=L)
    sel = (c > 10) & (k < k_max)
    return float(torch.sum(p[sel] * c[sel]) / torch.sum(c[sel]))


@contextlib.contextmanager
def plain_deposit():
    """``mesh_cuda.deposit`` is its plain twin while the block runs (the
    power spectrum's twin on the card)."""
    saved = mc.deposit
    mc.deposit = lambda c4, fm, grid, order, periodic=False, **kw: mc.deposit_plain(c4, fm, grid, order, periodic)
    try:
        yield
    finally:
        mc.deposit = saved


def _power_spectrum_agrees(tag: str, pos_mass: torch.Tensor, grid: int, L: float) -> None:
    """``power_spectrum`` by the kernel route (one ``mesh_deposit``) against
    the plain twin on the same state: mode counts bit-equal, P within rtol
    1e-4 and 1e-6 of the largest bin (f32 rounding of the deposit's sums)."""
    before = launch_counts()["mesh_deposit"]
    k, p, c = analysis.power_spectrum(pos_mass, grid=grid, box_size=L)
    launched = launch_counts()["mesh_deposit"] - before
    with plain_deposit():
        k2, p2, c2 = analysis.power_spectrum(pos_mass, grid=grid, box_size=L)
    excess = float(((p - p2).abs() - 1e-4 * p2.abs()).max())
    check(launched == 1 and torch.equal(c, c2) and torch.equal(k, k2) and excess <= 1e-6 * float(p2.abs().max())
          and bool(torch.isfinite(p).all()),
          f"{tag}: power_spectrum grid {grid} kernel route ({launched} mesh_deposit launch) vs plain twin: mode "
          f"counts bit-equal ({int(c.sum())} modes), P worst |diff| - 1e-4|ref| {excess:.3e} <= 1e-6 of max "
          f"{float(p2.abs().max()):.4e}")


def phase_cosmo_checks(dev, n1: int = 32) -> None:
    """15a: at a small shape.  A Zel'dovich box of 32^3 bodies (box 10,
    grid 32, k = 128: no tile overflows, so the inherited nbr_k fault stays
    out): for EdS and ΛCDM (Ω_Λ = 0.7) × PM and P3M, 5 comoving steps by the
    kernel route against ``backend="jnp"`` on the card (positions and
    momenta rtol 1e-4, atol 1e-5 of the max); tests/test_expansion.py's EdS
    growth gate on the card's kernels (P3M, amp 0.02, a = 1 to 2.25 in 70
    steps: the low-k band power (k < 0.5π·16/L) within 8% of a², the
    comoving momentum < 1e-4 of Σ|m·w|); ``power_spectrum`` by the kernel
    route against its twin (grids 32 and 64); the streamed FoF against the
    direct one as tests/test_analysis.py::test_fof_streamed_matches_exact
    holds them."""
    L, grid, nbr_k = 10.0, n1, 128
    n = n1**3
    print(f"[15a cosmo] comoving steps, growth gate, P(k) and FoF at {n1}^3 = {n:,} bodies, box {L:g}, grid {grid}, "
          f"k {nbr_k}", flush=True)
    for cosmology in ("eds", "lcdm"):
        pm_np, vel_np, _ = make_preset("cosmo", seed=11, G=G, n=n, box_size=L, amp=0.02, velocity=cosmology)
        ps, vel = torch.from_numpy(pm_np).to(dev), torch.from_numpy(vel_np).to(dev)
        ov = p3m.p3m_neighbor_overflow(ps, grid=grid, nbr_k=nbr_k, box_size=L)
        dt = 0.04 * _eds_t_i(float(pm_np[:, 3].sum()), G, L)
        for method in ("pm", "p3m"):
            cfg = _cosmo_config(method, cosmology, grid, nbr_k, L, G=G)
            states = {}
            for route, c in (("kernels", cfg), ("jnp", cfg.replace(backend="jnp"))):
                step = make_step_fn(c, n, n, dev)
                st = SimState(ps.clone(), vel.clone(), torch.zeros_like(ps), 0)
                for _ in range(5):
                    st = step(st, dt, G)
                states[route] = st
            torch.cuda.synchronize()
            moved = float((states["kernels"].pos_mass[:, :3] - ps[:, :3]).abs().max())
            for what, a, b in (("positions", states["kernels"].pos_mass, states["jnp"].pos_mass),
                               ("momenta", states["kernels"].vel, states["jnp"].vel)):
                a, b = a[:, :3], b[:, :3]
                scale = float(b.abs().max())
                excess = float(((a - b).abs() - 1e-4 * b.abs()).max())
                check(excess <= 1e-5 * scale and bool(torch.isfinite(a).all()),
                      f"[15a cosmo route] {cosmology} {method} N={n} (overflow {ov}), 5 steps of dt = 0.04 t_i "
                      f"(moved up to {moved:.3e}): kernel route vs jnp route, {what}: worst |diff| - 1e-4|ref| = "
                      f"{excess:.3e} <= {1e-5 * scale:.3e}")
    check(ov == 0, f"[15a cosmo] tile overflow at k = {nbr_k}: {ov} = 0")

    # tests/test_expansion.py::test_eds_linear_growth_matches_a_squared at 32^3.
    pm_np, vel_np, _ = make_preset("cosmo", seed=11, G=G, n=n, box_size=L, amp=0.02, velocity="eds")
    t_i, a_end, n_steps = _eds_t_i(float(pm_np[:, 3].sum()), G, L), 2.25, 70
    dt = t_i * (a_end**1.5 - 1.0) / n_steps
    sim = Simulation(_cosmo_config("p3m", "eds", grid, nbr_k, L, G=G, dt=dt), pm_np, vel_np, device=dev)
    bands = {"low-k band k < 0.5π·16/L": 0.5 * np.pi * 16 / L, f"half Nyquist k < 0.5π·{n1}/L": 0.5 * np.pi * n1 / L}
    pm0 = torch.from_numpy(pm_np).to(dev)
    p0 = {b: _band_power(pm0, grid, L, k_max) for b, k_max in bands.items()}
    t0 = time.perf_counter()
    sim.run(n_steps, chunk=n_steps)
    run_s = time.perf_counter() - t0
    ratios = {b: _band_power(sim.state.pos_mass, grid, L, k_max) / p0[b] for b, k_max in bands.items()}
    w = sim.state.vel[:, :3].double() * pm0[:, 3:4].double()
    mom = float(w.sum(dim=0).norm() / w.abs().sum())
    low = next(iter(ratios))
    print(f"[15a cosmo growth] EdS P3M N={n}, {n_steps} steps ({run_s:.3f} s), a = {sim.scale_factor:.6f}: band power "
          "grew " + ", ".join(f"{r:.4f}× ({b})" for b, r in ratios.items()) + f" against a² = {a_end**2:.4f}",
          flush=True)
    check(abs(sim.scale_factor - a_end) < 1e-5 and abs(ratios[low] / a_end**2 - 1.0) < 0.08,
          f"[15a cosmo growth] {low}: {ratios[low]:.4f} within 8% of a² = {a_end**2:.4f} "
          f"({ratios[low] / a_end**2 - 1:+.4f})")
    check(mom < 1e-4, f"[15a cosmo growth] comoving momentum |Σ m w| {mom:.3e} < 1e-4 of Σ|m w|")
    for g in (grid, 2 * grid):
        _power_spectrum_agrees("[15a cosmo P(k)]", sim.state.pos_mass, g, L)

    # tests/test_analysis.py::test_fof_streamed_matches_exact on the card.
    rng = np.random.default_rng(7)
    centers = rng.uniform(-4, 4, size=(6, 3))
    pts = np.concatenate([c + rng.normal(scale=0.02, size=(50, 3)) for c in centers] + [rng.uniform(-6, 6, (40, 3))])
    pm = np.concatenate([pts, rng.uniform(1, 50, size=(len(pts), 1))], axis=1).astype(np.float32)
    labels_e, _ = analysis.fof_groups(pm, 0.08)
    labels_s, _, pm_q = analysis.fof_groups_streamed(torch.from_numpy(pm).to(dev), 0.08)

    def parts(labels):
        groups = {}
        for i, lab in enumerate(labels):
            groups.setdefault(int(lab), set()).add(i)
        return sorted(map(frozenset, groups.values()), key=min)

    ext = pts.max(0) - pts.min(0)
    cat_e = analysis.group_catalog(pm, np.zeros_like(pm), labels_e, min_size=20)
    cat_s = analysis.group_catalog(pm_q, None, labels_s, min_size=20)
    check(parts(labels_e) == parts(labels_s) and np.max(np.abs(pm_q[:, :3] - pm[:, :3])) <= ext.max() / (1 << 21)
          and np.allclose(pm_q[:, 3], pm[:, 3], rtol=1e-3) and [g["n"] for g in cat_e] == [g["n"] for g in cat_s]
          and np.allclose([g["mass"] for g in cat_e], [g["mass"] for g in cat_s], rtol=1e-3)
          and "vcom" not in cat_s[0] and "vcom" in cat_e[0],
          f"[15a cosmo FoF] streamed (quantized on the card) vs direct: the same partition ({len(parts(labels_e))} "
          f"groups, {len(cat_e)} of >= 20), positions within extent/2^21, masses and catalog masses rtol 1e-3")


def _cosmo_run(dev, tag: str, method: str, cosmology: str, chunks: int, chunk: int, warm: int, base: str):
    """The ``cosmo`` preset at 128^3 in 15b's box through ``Simulation``
    (dt = t_i / 100: a step moves a by ~0.7%), ``warm`` steps with the
    momentum gate and the timed chunks (:func:`_mesh_run`), its ms/step
    beside ``base``'s from this call."""
    torch.cuda.reset_peak_memory_stats()
    n = COSMO_N1**3
    cfg = _cosmo_config(method, cosmology, 128, 32, COSMO_L, G=G)
    sim = Simulation.from_preset("cosmo", cfg, n=n, device=dev, box_size=COSMO_L, velocity=cosmology)
    sim.dt = _eds_t_i(float(sim.state.pos_mass[:, 3].double().sum()), G, COSMO_L) / 100  # before any step
    ms = _mesh_run(sim, f"{tag} cosmo N={sim.n_real} box {COSMO_L:g} grid 128" + (" k 32" if method == "p3m" else ""),
                   chunks=chunks, chunk=chunk, warm=warm)
    ms_base = PERIODIC_MS.get(base)
    PERIODIC_MS[tag] = ms
    print(f"{tag}: comoving {ms:.4f} ms/step, a = {sim.scale_factor:.6f} at step {sim.step_count}; {base} (the "
          f"plain periodic step, this call) {ms_base:.4f} ms/step: {ms - ms_base:+.4f} ms/step", flush=True)
    COSMO_SIMS[tag] = sim
    return [(f"{tag} one step", lambda: sim.run(1, chunk=1)), functools.partial(_launches_a_step, tag, sim)]


def _launches_a_step(tag: str, sim: Simulation, steps: int = 3) -> None:
    """The comoving step against the plain periodic step
    (``cosmology="none"``, the frame-shifted Verlet) on copies of the same
    state: each step function warmed by one step (the comoving step copies
    its constants to the card once), then ``steps`` steps in one profiled
    chunk, in turns twice: the device's launches a step, in all and by
    kernel, its busy time and the host's wall time a step."""
    from nbody3d_tpu_torch.ops.step import run_chunk

    def state():
        st = sim.state
        return SimState(st.pos_mass.clone(), st.vel.clone(), st.accel.clone(), st.step)

    steps_fn = {"comoving": sim.config, "plain periodic": sim.config.replace(cosmology="none")}
    steps_fn = {name: make_step_fn(cfg, sim.n_pad, sim.n_real, sim.device) for name, cfg in steps_fn.items()}
    per_step: dict[str, list] = {name: [] for name in steps_fn}
    for name, step in [*steps_fn.items(), *reversed(steps_fn.items())]:
        run_chunk(step, state(), sim.dt, sim.G, 1)
        wall_us, events, complete = _profiled(lambda: run_chunk(step, state(), sim.dt, sim.G, steps))
        counts: dict[str, int] = {}
        for label, _, _ in events:
            counts[label] = counts.get(label, 0) + 1
        per_step[name].append((len(events) / steps, counts, complete, _busy_us(events) / steps / 1e3,
                               wall_us / steps / 1e3))
    (n_c, c_c, ok_c, busy_c, _), (n_p, c_p, ok_p, busy_p, _) = per_step["comoving"][0], per_step["plain periodic"][0]
    extra = {k: (c_c.get(k, 0) - c_p.get(k, 0)) / steps for k in set(c_c) | set(c_p) if c_c.get(k, 0) != c_p.get(k, 0)}
    walls = {name: [round(r[4], 4) for r in runs] for name, runs in per_step.items()}
    print(f"  launches a step {tag}: comoving {n_c:.2f}, plain periodic step {n_p:.2f} on the same state: "
          f"{n_c - n_p:+.2f} a step (traces complete: {ok_c}, {ok_p}); device busy {busy_c:.4f} against {busy_p:.4f} "
          f"ms a step, wall ms a step in turns {json.dumps(walls)}; the difference by kernel: "
          + json.dumps({k: round(v, 2) for k, v in sorted(extra.items(), key=lambda kv: -kv[1])})
          + "; by kernel, comoving: "
          + json.dumps({k: round(v / steps, 2) for k, v in sorted(c_c.items(), key=lambda kv: -kv[1])}), flush=True)


def phase_cosmo_p3m(dev):
    """15b: the comoving EdS P3M cell at 12b's N, box, grid and k: 30 warm
    steps and 2 timed chunks of 10, beside 12b."""
    return _cosmo_run(dev, "[15b cosmo eds p3m]", "p3m", "eds", 2, 10, 30, "[12b periodic p3m]")


def phase_cosmo_p3m_lcdm(dev):
    """15b: the same with ΛCDM (Ω_Λ = 0.7), one warm step and one timed
    chunk of 10."""
    return _cosmo_run(dev, "[15b cosmo lcdm p3m]", "p3m", "lcdm", 1, 10, 1, "[12b periodic p3m]")


def phase_cosmo_pm(dev):
    """15b: the comoving EdS PM cell at 12d's shape, 5 timed chunks of 50,
    beside 12d."""
    return _cosmo_run(dev, "[15b cosmo eds pm]", "pm", "eds", 5, 50, 30, "[12d periodic pm]")


def phase_cosmo_fault(dev) -> None:
    """After the windows: the inherited nbr_k fault at 15b's comoving state,
    reported as 12b's and not gated (ROADMAP queue 3)."""
    _box_fault(COSMO_SIMS["[15b cosmo eds p3m]"], label="15b cosmo")
    for tag in ("[15b cosmo lcdm p3m]", "[15b cosmo eds pm]"):
        del COSMO_SIMS[tag]


def _host_ms(fn):
    """``(fn(), host ms)`` on the host clock, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_cosmo_analysis(dev) -> None:
    """15c: the analysis of 15b's EdS P3M end state on the card, each on the
    host clock ending in a synchronize: ``summary`` (structural, no O(N²)
    potential; its device-to-host copies counted by the profiler, which
    must be 1), ``power_spectrum`` at grid 128 (its one ``mesh_deposit``
    launch), the direct and the streamed FoF on the 2M bodies, and
    ``group_catalog``."""
    sim = COSMO_SIMS.pop("[15b cosmo eds p3m]")
    n, L = sim.n_real, COSMO_L
    pm_d, vel_d = sim.state.pos_mass[:n], sim.state.vel[:n]
    print(f"[15c cosmo analysis] 15b's EdS P3M end state, N={n}, a = {sim.scale_factor:.6f}", flush=True)
    summarize = functools.partial(analysis.summary, pm_d, vel_d, sim.G, eps2=sim.config.eps2, potential=False)
    summarize()  # warm
    s, summary_ms = _host_ms(summarize)
    _, events, complete = _profiled(summarize)
    d2h = sum("DtoH" in label for label, _, _ in events)
    check(d2h == 1 and s["n_massive"] == n and all(np.isfinite(s[k]).all() for k in ("com", "velocity_dispersion")),
          f"[15c summary] {summary_ms:.3f} ms, {d2h} device-to-host copy (profiler, trace complete {complete}) == 1; "
          f"n_massive {s['n_massive']}, r50 {s['lagrangian_radii']['r50']:.6g}, total mass {s['total_mass']:.6e}")
    before = launch_counts()["mesh_deposit"]
    (k, p, c), ps_ms = _host_ms(lambda: analysis.power_spectrum(pm_d, grid=128, box_size=L))
    launched = launch_counts()["mesh_deposit"] - before
    shot = float(analysis.shot_noise(pm_d, L**3))
    check(launched == 1 and bool(torch.isfinite(p).all()) and int(c.sum()) > 0,
          f"[15c power_spectrum] grid 128: {ps_ms:.3f} ms, {launched} mesh_deposit launch, {int(c.sum())} modes in "
          f"{c.numel()} bins; P(k={float(k[1]):.4g}) = {float(p[1]):.4e}, P(k={float(k[-1]):.4g}) = "
          f"{float(p[-1]):.4e}, shot noise {shot:.4e}")
    _power_spectrum_agrees("[15c power_spectrum]", pm_d, 128, L)

    (pm_h, vel_h), fetch_ms = _host_ms(lambda: (pm_d.cpu().numpy(), vel_d.cpu().numpy()))
    (labels, ll), fof_ms = _host_ms(lambda: analysis.fof_groups(pm_h, box_size=L))
    (labels_s, ll_s, pm_q), stream_ms = _host_ms(lambda: analysis.fof_groups_streamed(pm_d, box_size=L))
    cat, cat_ms = _host_ms(lambda: analysis.group_catalog(pm_h, vel_h, labels, min_size=20, box_size=L))
    cat_s = analysis.group_catalog(pm_q, None, labels_s, min_size=20, box_size=L)

    def linked(lab):
        return int((np.bincount(lab)[lab] > 1).sum())

    ld, ls = linked(labels), linked(labels_s)
    print(f"[15c FoF] N={n}, b = {ll:.6g} (0.2 of the mean separation): direct {fetch_ms:.3f} ms to fetch 32 B a "
          f"body + {fof_ms:.3f} ms, streamed {stream_ms:.3f} ms (10 B a body); group_catalog {cat_ms:.3f} ms; "
          f"bodies linked {ld:,} direct, {ls:,} streamed; groups of >= 20: {len(cat)} direct, {len(cat_s)} streamed",
          flush=True)
    check(ll == ll_s and (labels >= 0).all() and abs(ld - ls) <= 1e-3 * n and abs(len(cat) - len(cat_s)) <= max(1, len(cat) // 100),
          f"[15c FoF] streamed vs direct: the same linking length, linked bodies within 1e-3 of N "
          f"({abs(ld - ls)}), groups of >= 20 within 1% ({len(cat)} vs {len(cat_s)})")


# ------------------------------------------------------- the live viewer
def _quantized_agrees(tag: str, prep, w: int, h: int) -> torch.Tensor:
    """The quantized resolve on the card (``scatter_reduce_`` there, the
    large splats stamped on the host) against the CPU route on a copy of
    the same prep: the framebuffers bit-equal."""
    got = resolve.resolve_quantized(*prep, width=w, height=h)
    want = resolve.resolve_quantized(*(t.cpu() for t in prep), width=w, height=h)
    n_large = int((prep[5] & (prep[4] >= resolve.DEVICE_RMAX)).sum())
    lit = int((got != resolve.EMPTY32).sum())
    check(torch.equal(got, want) and lit > 0,
          f"{tag}: CUDA route == CPU route ({int(prep[5].sum())} visible splats, {n_large} stamped on the host, "
          f"{lit} pixels lit)")
    return got


def device_resolve_scenes() -> dict:
    """16a's scenes: tests/test_render.py:206-246 (20k bodies 320x240, one
    body 128x128) and the two-galaxy frame."""
    return {
        "20k dense, 320x240 (tests/test_render.py:206)": (*render_scene(20_000, 13), Camera(target=np.zeros(3), radius=4.0),
                                                          dict(width=320, height=240)),
        "one body, 128x128 (tests/test_render.py:237)": (np.array([[0, 0, 0, 100.0]], np.float32),
                                                         np.zeros((1, 4), np.float32),
                                                         Camera(target=np.zeros(3), radius=5.0),
                                                         dict(width=128, height=128)),
        "two-galaxy N=40,002, 1024x768": _two_galaxy_frame(),
    }


def phase_device_resolve_checks(dev) -> None:
    """16a: the quantized ``device`` resolve on the card: bit-equal to the
    CPU route on the same prep, and the JAX package's contract against the
    exact ``auto`` frame (lit pixels agree on > 0.999, rgb within 8 on >
    0.995; one body: its pixel within 8); then at N = 500,010 1920x1080 its
    frame beside the ``auto`` frame (``splat_resolve``) and the bytes each
    copies to the host."""
    print("[16a device resolve] quantized scatter on the card vs the CPU route and the exact frame", flush=True)
    for name, (pm, vel, cam, frame) in device_resolve_scenes().items():
        w, h = frame["width"], frame["height"]
        buf = _quantized_agrees(f"[16a] {name}", _prep(pm, vel, cam, frame, dev), w, h)
        img = resolve.quantized_image(buf, width=w, height=h)
        pm_d, vel_d = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pm, vel))
        check(np.array_equal(rasterize.render_points(pm_d, vel_d, cam, resolve="device", **frame), img),
              f"[16a] {name}: render_points(resolve='device') == the resolve's image")
        exact = rasterize.render_points(pm_d, vel_d, cam, **frame)
        lit_e, lit_q = exact.any(axis=2), img.any(axis=2)
        both = lit_e & lit_q
        close = (np.abs(exact[both].astype(int) - img[both].astype(int)) <= 8).all(axis=1)
        lit_ok = (lit_e == lit_q).mean() > 0.999
        if pm.shape[0] == 1:
            ok, bar = bool(both[h // 2, w // 2]) and bool(close.all()), "its pixel within 8"
        elif name.startswith("two-galaxy"):
            # Not gated: a galaxy's narrow depth range ties at 16 bits, and the
            # JAX package's own device resolve has the port's share there
            # (tests/test_torch_viewer.py::test_device_resolve_two_galaxy_as_jax).
            ok, bar = lit_ok, "rgb share reported, not gated"
        else:
            ok, bar = lit_ok and close.mean() > 0.995, "> 0.995"
        check(ok, f"[16a] {name} vs the exact auto frame: lit pixels agree on {(lit_e == lit_q).mean():.6f} "
                  f"(> 0.999), rgb within 8 on {close.mean():.6f} of {int(both.sum())} ({bar})")
    pm, vel = render_scene(500_010, 0)
    big = dict(width=1920, height=1080)
    cam = Camera(target=np.zeros(3), radius=5.0)
    prep = _prep(pm, vel, cam, big, dev)
    _quantized_agrees("[16a] N=500,010 1920x1080", prep, 1920, 1080)
    pm_d, vel_d = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pm, vel))
    ms = {}
    for res in ("auto", "device", "auto", "device"):  # in turns
        rasterize.render_points(pm_d, vel_d, cam, resolve=res, **big)
        ms.setdefault(res, []).append(statistics.median(
            host_ms(lambda: rasterize.render_points(pm_d, vel_d, cam, resolve=res, **big)) for _ in range(3)))
    n_large = int((prep[5] & (prep[4] >= resolve.DEVICE_RMAX)).sum())
    auto_b, dev_b = 1920 * 1080 * 3, 1920 * 1080 * 4 + 32 * n_large
    print(f"  [16a] N=500,010 1920x1080 frame, host clock, synced, median of 3, in turns: device resolve "
          f"{ms['device']} ms (copies {dev_b:,} B: the int32 buffer and {n_large} large splats at 32 B), auto "
          f"(splat_resolve) {ms['auto']} ms (copies {auto_b:,} B: the uint8 image)", flush=True)


def _jpeg_size(data: bytes) -> tuple[int, int]:
    """(width, height) from a baseline JPEG's SOF0."""
    i = data.index(b"\xff\xc0")
    h, w = struct.unpack(">HH", data[i + 5:i + 9])
    return w, h


def _http(port: int, path: str, body: bytes | None = None) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST" if body is not None else "GET", path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _stream_parts(port: int, parts: int) -> list[bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        out = []
        for _ in range(parts):
            head = [resp.readline() for _ in range(4)]  # boundary, type, length, blank line
            out.append(resp.read(int(head[2].split(b":")[1])))
            resp.readline()
        return out
    finally:
        conn.close()


def _until(pred, timeout: float = 60.0) -> bool:
    deadline = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() > deadline:
            return False
        time.sleep(0.02)
    return True


def _jpeg_ok(data: bytes) -> bool:
    return data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"


SERVE_W, SERVE_H, SERVE_K = 960, 720, 20


def phase_serve(dev):
    """16b: ``LiveViewer`` on the reference default (two-galaxy N = 40,002,
    exact, 960x720, 20 steps a frame) on an ephemeral port in this process,
    every HTTP call with a timeout: /stats, /frame.jpg, /stream, /control,
    export and import, regenerate; then, with the loop stopped, the
    sequential parts of a frame and (after the counts) a profiled frame."""
    from nbody3d_tpu_torch.render.jpeg import encode_jpeg
    from nbody3d_tpu_torch.viewer import LiveViewer

    sim = Simulation.from_preset("two-galaxy", SimConfig(), device=dev)
    d0 = sim.diagnostics()
    v = LiveViewer(sim, width=SERVE_W, height=SERVE_H, steps_per_frame=SERVE_K)
    server = v.make_server("127.0.0.1", 0)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    print(f"[16b serve] LiveViewer two-galaxy N={sim.n_real} exact, {SERVE_W}x{SERVE_H}, {SERVE_K} steps a frame, "
          f"http://127.0.0.1:{port}/", flush=True)

    def sample():
        with v._sim_lock:
            return v.sim.step_count, v.chunks_done, v._frames_done, time.perf_counter()

    t_start = time.perf_counter()
    try:
        v.start()
        # The energy window: ten pipelined frames from the start, then pause.
        check(_until(lambda: v.chunks_done >= 10), f"[16b] ten pipelined frames ({v.chunks_done})")
        st, body = _http(port, "/frame.jpg")
        check(st == 200 and _jpeg_ok(body) and _jpeg_size(body) == (SERVE_W, SERVE_H),
              f"[16b] /frame.jpg: {st}, SOI/EOI, {_jpeg_size(body)}, {len(body):,} B")
        parts = _stream_parts(port, 3)
        check(len(parts) == 3 and all(map(_jpeg_ok, parts)), f"[16b] /stream: 3 parts, SOI/EOI, {[len(p) for p in parts]} B")
        check(_http(port, "/control?pause=1")[0] == 204 and v.sim.paused, "[16b] /control?pause=1")
        frames = v._frames_done
        _until(lambda: v._frames_done >= frames + 2)
        with v._sim_lock:
            steps, chunks, d1 = v.sim.step_count, v.chunks_done, v.sim.diagnostics()
        drift = abs(float(d1.total_energy) - float(d0.total_energy)) / abs(float(d0.total_energy))
        check(steps == SERVE_K * chunks and drift <= 1e-3,
              f"[16b] {chunks} pipelined frames advanced {steps} steps (20 a frame); energy drift {drift:.3e} <= 1e-3")
        # Paused: the served frame is the encode of render_frame at the same camera.
        cam, w, h = v._snapshot()
        st, served = _http(port, "/frame.jpg")
        want = encode_jpeg(v.sim.render_frame(camera=cam, width=w, height=h), v.quality)
        check(st == 200 and served == want, f"[16b] paused /frame.jpg == encode_jpeg(render_frame(same camera)) "
                                             f"({len(served):,} B)")
        az0, r0, target0 = v.camera.azimuth, v.camera.radius, v.camera.target.copy()
        codes = [_http(port, f"/control?{q}")[0] for q in ("orbit=40,10", "pan=15,-5", "zoom=0.3", "logdt=-3.8",
                                                            "size=640x480")]
        moved = v.camera.azimuth != az0 and v.camera.radius > r0 and not np.array_equal(v.camera.target, target0)
        frames = v._frames_done
        _until(lambda: v._frames_done >= frames + 2)
        st, small = _http(port, "/frame.jpg")
        stats = json.loads(_http(port, "/stats")[1])
        check(codes == [204] * 5 and moved and _jpeg_size(small) == (640, 480) and stats["resolution"] == "640x480"
              and stats["paused"] and abs(stats["dt"] - 10**-3.8) < 1e-12,
              f"[16b] /control orbit, pan, zoom, logdt, size: {codes}, camera {stats['camera']}, frame "
              f"{_jpeg_size(small)}, dt {stats['dt']:.6g} (applied on unpause)")
        check(_http(port, "/control?reset=1")[0] == 204 and np.isclose(v.camera.radius, 5.0), "[16b] /control?reset=1")
        # Export and import while paused: the file holds the paused dt, 0, so
        # the imported sim runs from the next dt slider move (as the JAX
        # package's viewer, whose checkpoints store the live dt).
        st, npz = _http(port, "/export.npz")
        st2, _ = _http(port, "/import.npz", npz)
        with np.load(io.BytesIO(npz)) as z, v._sim_lock:
            same = all(np.array_equal(z[k], a) for k, a in zip(("pos_mass", "vel", "accel"), v.sim.arrays()))
            same &= int(z["step"]) == v.sim.step_count
        check(st == 200 and st2 == 204 and same, f"[16b] /export.npz ({len(npz):,} B) then POST /import.npz: the "
                                                 "imported state equals the exported one bit for bit")
        _http(port, f"/control?size={SERVE_W}x{SERVE_H}")
        check(_http(port, "/control?logdt=-3.8")[0] == 204 and not v.sim.paused and abs(v.sim.dt - 10**-3.8) < 1e-12,
              f"[16b] the imported sim (dt {v.sim.dt:.6g} after /control?logdt=-3.8) runs")
        c0 = v.chunks_done
        _until(lambda: v.chunks_done >= c0 + 2)  # the imported sim's first frames
        a = sample()
        time.sleep(2.0)
        b = sample()
        interval_ms = SERVE_MS["16b"] = (b[3] - a[3]) / max(b[2] - a[2], 1) * 1e3
        check(b[1] > a[1] and b[0] - a[0] == SERVE_K * (b[1] - a[1]),
              f"[16b] {b[1] - a[1]} pipelined frames in {b[3] - a[3]:.3f} s advanced {b[0] - a[0]} steps")
        stats = json.loads(_http(port, "/stats")[1])
        check(_http(port, "/control?regenerate=1")[0] == 204 and v.sim.n_real == 40_002,
              f"[16b] /control?regenerate=1: N={v.sim.n_real}")
        c0 = v.chunks_done
        check(_until(lambda: v.chunks_done >= c0 + 3, 30) and v.sim.step_count >= 3 * SERVE_K,
              f"[16b] the regenerated sim steps ({v.sim.step_count} steps)")
    finally:
        v.stop()
        server.shutdown()
        server.server_close()
        serving.join(timeout=10)
    window_s = time.perf_counter() - t_start
    check(v.error is None and not v._thread.is_alive() and not serving.is_alive(),
          f"[16b] loop and server stopped, no loop error ({v.error!r}); window {window_s:.3f} s")
    print(f"  [16b] stats: fps {stats['fps']:.3f}, frame {stats['frame_ms']:.3f} ms, compute {stats['compute_ms']:.3f} "
          f"ms, host {stats['host_ms']:.3f} ms, render {stats['render_ms']:.3f} ms, encode {v.encode_ms:.3f} ms, "
          f"JPEG {v.jpeg_bytes:,} B, {stats['steps_per_s']:.3f} steps/s", flush=True)
    # The sequential parts of a frame, the loop stopped: the chunk, the render, the encode.
    s = v.sim
    chunk_ms = statistics.median(host_ms(lambda: s.run(SERVE_K, chunk=SERVE_K)) for _ in range(3))
    render_ms = statistics.median(host_ms(lambda: s.render_frame(width=SERVE_W, height=SERVE_H)) for _ in range(3))
    img = s.render_frame(width=SERVE_W, height=SERVE_H)
    encode_ms = statistics.median(host_ms(lambda: encode_jpeg(img, v.quality)) for _ in range(3))

    def enqueue_ms() -> float:
        """The host's time to enqueue a chunk (``run_async``), the device idle before it."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        token = s.run_async(SERVE_K)
        t = (time.perf_counter() - t0) * 1e3
        s.wait_chunk(token)
        return t

    enqueue = statistics.median(enqueue_ms() for _ in range(3))
    print(f"  [16b] frame interval {interval_ms:.3f} ms (measured, pipelined) vs the sequential sum "
          f"{chunk_ms + render_ms + encode_ms:.3f} ms = chunk {chunk_ms:.3f} + render {render_ms:.3f} + encode "
          f"{encode_ms:.3f} (host clock, synced, median of 3); the host's enqueue of a chunk {enqueue:.3f} ms",
          flush=True)
    return [(f"16b one pipelined serve frame ({SERVE_W}x{SERVE_H}, {SERVE_K} steps)", v.pipelined_frame)]


def _gif_frames(data: bytes) -> int:
    """The image descriptors of a GIF89a, walking its blocks."""
    if data[:6] != b"GIF89a":
        return -1
    flags, pos, frames = data[10], 13, 0
    pos += 3 * 2 ** ((flags & 7) + 1) if flags & 0x80 else 0
    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            pos += 2
        else:
            frames += 1
            local = data[pos + 9]
            pos += 10 + (3 * 2 ** ((local & 7) + 1) if local & 0x80 else 0) + 1
        while data[pos]:
            pos += data[pos] + 1
        pos += 1
    return frames


def phase_animate(dev, out: pathlib.Path) -> None:
    """16c: ``cli animate`` of 7b's ``final.npz`` on the card, 12 frames
    (1024x768), as APNG and GIF: the APNG holds 12 frames (``acTL``), each
    equal to its frame PNG bit for bit; the GIF 12 images."""
    final, anim = str(out / "final.npz"), out / "anim"
    times = {}
    for fmt in ("apng", "gif"):
        argv = ["animate", final, "--device", dev.type, "--frames", "12", "--outdir", str(anim),
                "--video", str(anim / f"orbit.{fmt}")]
        t0 = time.perf_counter()
        rc = cli.main(argv)
        times[fmt] = time.perf_counter() - t0
        check(rc == 0, f"[16c] cli {' '.join(argv)}: rc {rc} in {times[fmt]:.3f} s")
    data = (anim / "orbit.apng").read_bytes()
    i = data.index(b"acTL")
    n_frames = struct.unpack(">I", data[i + 4:i + 8])[0]
    frames = read_apng(str(anim / "orbit.apng"))
    pngs = [read_png(str(anim / f"frame_{k:06d}.png")) for k in range(12)]
    check(n_frames == len(frames) == 12 and all(np.array_equal(a, b) for a, b in zip(frames, pngs))
          and np.array_equal(read_png(str(anim / "orbit.apng")), pngs[0]) and pngs[0].any(),
          f"[16c] orbit.apng ({len(data):,} B): acTL {n_frames} frames, each == its frame PNG bit for bit")
    gif = (anim / "orbit.gif").read_bytes()
    check(_gif_frames(gif) == 12, f"[16c] orbit.gif ({len(gif):,} B): GIF89a, {_gif_frames(gif)} images")


def phase_trace(dev, out: pathlib.Path) -> None:
    """16d: ``cli run --trace`` (two-galaxy, 20 steps) writes a
    ``torch.profiler`` trace that names ``fused_step_exact``."""
    argv = ["run", "--device", dev.type, "--preset", "two-galaxy", "--steps", "20", "--log-every", "10",
            "--outdir", str(out / "traced"), "--trace", str(out / "trace")]
    rc = cli.main(argv)
    path = out / "trace" / "trace.json"
    text = path.read_text() if path.exists() else ""
    check(rc == 0 and "fused_step_exact" in text and json.loads(text).get("traceEvents"),
          f"[16d] cli {' '.join(argv)}: rc {rc}, {path.name} {len(text):,} B names fused_step_exact "
          f"{text.count('fused_step_exact')} times")


# --------------------------------------------- 17: sharded direct stepping
REPLAY_D = (2, 4, 8)


def replay_ring(config: SimConfig, full: torch.Tensor, g: float, d: int, strategy: str) -> torch.Tensor:
    """Every rank's force of a D-rank ring or gather step in one process:
    the step's own hop (``sharded.hop_force`` with ``ring_diag`` or
    ``gather_diag``) on each rank's shard and, in place of the transfers,
    the slice the rank would hold at that hop (rank ``my - k``'s shard)."""
    shard = full.shape[0] // d
    force = sharded.hop_force(config, full.device)
    rows = [full[i * shard : (i + 1) * shard] for i in range(d)]
    out = []
    for my in range(d):
        if strategy == "gather":
            out.append(force(rows[my], full, g, sharded.gather_diag(my, shard)))
            continue
        acc = torch.zeros_like(rows[my])
        for k in range(d):
            acc += force(rows[my], rows[(my - k) % d], g, sharded.ring_diag(k))
        out.append(acc)
    return torch.cat(out)


def replay_ringsym(config: SimConfig, full: torch.Tensor, g: float, d: int, src_chunks: int | None = None):
    """Every rank's force of a D-rank ringsym step in one process: each
    rank's ``SymHops.self_force``, its ``pair_force`` with the shard of
    ``my - k`` at hop k (where ``ringsym_keeps``), the target part kept and
    the source part handed to rank ``my - k``, as the backward carry does."""
    shard = full.shape[0] // d
    hops = sharded.SymHops(config, shard, full.device, src_chunks)
    rows = [full[i * shard : (i + 1) * shard] for i in range(d)]
    acc = [hops.self_force(r, g) for r in rows]
    for my in range(d):
        for k in range(1, d // 2 + 1):
            if sharded.ringsym_keeps(k, my, d):
                at, ar = hops.pair_force(rows[my], rows[(my - k) % d], g)
                acc[my] += at
                acc[(my - k) % d] += ar
    return torch.cat(acc), hops


def replay_grid(config: SimConfig, full: torch.Tensor, g: float, nrows: int, ncols: int) -> torch.Tensor:
    """Every rank's force of an R x C grid step in one process: rank (r, c)'s
    tile, target segment r against source set c (the pieces ``i*C + c``),
    with ``grid_diag``; the reduce-scatter over "col" is the sum over c."""
    m = full.shape[0] // (nrows * ncols)
    seg = ncols * m
    force = sharded.hop_force(config, full.device)
    out = torch.zeros_like(full)
    for r in range(nrows):
        for c in range(ncols):
            src = torch.cat([full[(i * ncols + c) * m : (i * ncols + c + 1) * m] for i in range(nrows)])
            out[r * seg : (r + 1) * seg] += force(full[r * seg : (r + 1) * seg], src, g, sharded.grid_diag(r, c, m))
    return out


def _replay_agrees(tag: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> None:
    torch.cuda.synchronize()
    e = rel_err(got[:, :3], want[:, :3])
    check(bool(torch.isfinite(got).all()) and e < tol, f"[17a replay] {tag}: every rank's force vs the single-device "
          f"kernel {e:.3e} < {tol:g} of scale")


def phase_sharded_replay(dev) -> None:
    """17a: the D-rank schedules replayed rank by rank in one process at
    full width, each rank's assembled force against the single-device
    kernel: exact two-galaxy N = 40,002 (ring and gather at D = 2, 4, 8 and
    the 2 x 2 grid, exact and fast), sym uniform-sphere N = 262,144 (ringsym
    at D = 2, 4, 8, and D = 2 with two source chunks a pair hop)."""
    print("[17a sharded replay] every rank's hops at D = 2, 4, 8 and 2 x 2, full width", flush=True)
    t0 = time.perf_counter()
    pm_np, vel_np, _ = make_preset("two-galaxy", seed=0, G=G)
    n = pm_np.shape[0]
    for mode, tol in (("exact", 1e-5), ("fast", FAST_TWIN_TOL)):
        config = SimConfig(force_mode=mode)
        single = cf.force_exact if mode == "exact" else cf.force_fast
        for n_pad in sorted({pad_count(n, PAD_GRANULE * d) for d in REPLAY_D + (4,)}):
            full = init_state(pm_np, vel_np, n_pad=n_pad, device=dev).pos_mass
            want = single(full, full, G, EPS2)
            for d in REPLAY_D:
                if pad_count(n, PAD_GRANULE * d) != n_pad:
                    continue
                for strategy in ("ring", "gather"):
                    _replay_agrees(f"{mode} two-galaxy N={n} (n_pad {n_pad}) {strategy} D={d}",
                                   replay_ring(config, full, G, d, strategy), want, tol)
            if n_pad == pad_count(n, PAD_GRANULE * 4):
                _replay_agrees(f"{mode} two-galaxy N={n} (n_pad {n_pad}) 2d 2x2",
                               replay_grid(config, full, G, 2, 2), want, tol)
    config = SimConfig(force_mode="sym")
    pm_np, vel_np, _ = make_preset("uniform-sphere", seed=0, G=G, n=262_144)
    full = init_state(pm_np, vel_np, device=dev).pos_mass
    want = make_sym_accel_fn(config, full.shape[0])(full, G)
    for d, chunks in ((2, None), (4, None), (8, None), (2, 2)):
        got, hops = replay_ringsym(config, full, G, d, chunks)
        _replay_agrees(f"sym uniform-sphere N={full.shape[0]} ringsym D={d}, {hops.src_chunks} source chunk(s) "
                       f"a pair hop, tile {hops.b}", got, want, 2e-5)
    print(f"  17a: {time.perf_counter() - t0:.1f} s", flush=True)


class OneRankGroup:
    """A process group of one rank over NCCL (a ``file://`` store in a
    temporary directory) for phase 17's sharded runs on the one card; the
    1-D mesh and the 1 x 1 grid over it."""

    def __enter__(self):
        self._tmp = tempfile.TemporaryDirectory()
        dist.init_process_group("nccl", init_method=f"file://{self._tmp.name}/store", rank=0, world_size=1)
        SHARDED["x"] = default_mesh(1)
        SHARDED["2d"] = grid_mesh(1, 1)
        return self

    def __exit__(self, *exc):
        SHARDED.clear()
        dist.destroy_process_group()
        self._tmp.cleanup()


SHARDED: dict = {}  # phase 17's meshes while OneRankGroup holds the process group


def phase_sharded_ring(dev) -> None:
    """17b: phase 4's run through ``Simulation(mesh=default_mesh(1))``,
    strategy ring (one rank: the gather), phase 4's token, ms/step beside
    phase 4's."""
    ms = MAIN["phase 17b"] = _exact_run(dev, "17b sharded ring, 1 rank", mesh=SHARDED["x"], strategy="ring")
    one = MAIN.get("phase 4", float("nan"))
    print(f"  sharded ring {ms:.4f} vs one device (phase 4) {one:.4f} ms/step ({ms / one - 1:+.2%})", flush=True)


def phase_sharded_ringsym(dev) -> None:
    """17c: phase 5's run through ``Simulation(mesh=default_mesh(1))``,
    strategy ring with ``force_mode="sym"`` (ringsym: the sym chain on the
    shard, no pair hop), phase 5's token, ms/step beside phase 5's."""
    ms = MAIN["phase 17c"] = _sphere_run(dev, "17c sharded ringsym, 1 rank", chunk=50, mesh=SHARDED["x"],
                                         strategy="ring")[0]
    one = MAIN.get("phase 5", float("nan"))
    print(f"  ringsym {ms:.4f} vs the fused sym step (phase 5) {one:.4f} ms/step ({ms / one - 1:+.2%})", flush=True)


def phase_sharded_gather_2d(dev) -> None:
    """17d: two-galaxy through the gather (1 rank) and the 2-D grid (1 x
    1), one chunk of 50 each, against one device's run from the same state
    (bit-equal: one rank gathers and reduces copies), and the sharded
    diagnostics against the single-device ones (rtol 1e-5)."""
    pm_np, vel_np, _ = make_preset("two-galaxy", seed=0, G=G)
    one = Simulation(SimConfig(), pm_np, vel_np, device=dev)
    one.run(50, chunk=50)
    want = one.arrays()
    d_one = one.diagnostics()
    for strategy, mesh in (("gather", SHARDED["x"]), ("2d", SHARDED["2d"])):
        sim = Simulation(SimConfig(strategy=strategy), pm_np, vel_np, mesh=mesh)
        t0 = time.perf_counter()
        sim.run(50, chunk=50)
        ms = (time.perf_counter() - t0) / 50 * 1e3
        got = sim.arrays()
        err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        check(err == 0.0, f"[17d] {strategy} on mesh {mesh.shape}: 50 steps ({ms:.4f} ms/step) bit-equal to one "
              f"device's (max |diff| {err:.3e})")
        d = sim.diagnostics()
        e = max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
                for a, b in ((d.kinetic, d_one.kinetic), (d.potential, d_one.potential),
                             (d.total_energy, d_one.total_energy), (d.total_mass, d_one.total_mass)))
        pscale = float(np.abs(want[0][:, 3:4] * want[1][:, :3]).sum())
        em = float(np.abs(np.asarray(d.momentum) - np.asarray(d_one.momentum)).max()) / pscale
        check(e <= 1e-5 and em <= 1e-6, f"[17d] {strategy}: sharded diagnostics vs one device's: energies and "
              f"mass {e:.3e} <= 1e-5, momentum {em:.3e} <= 1e-6 of sum |m v|")


# ------------------------------------------------ 18: sharded PM and P3M
def _card() -> str:
    return f"card {CARD['smi']}"


def replay_mesh(config: SimConfig, full: torch.Tensor, n_real: int, d: int, g: float = G):
    """Every rank's sharded mesh force of a D-rank step in one process
    (``mesh_force``'s force over ``exchange.ReplayGroup``: the collectives
    as sums and concatenations over the list) on the kernel route:
    ``(force, per-rank accelerations, trace)``."""
    force = (ShardedP3M if config.method == "p3m" else ShardedPM)(config, full.shape[0], n_real, d, "kernels")
    trace: dict = {}
    acc = force.accel(ReplayGroup(d), list(full.view(d, -1, 4)), g, trace)
    torch.cuda.synchronize()
    return force, acc, trace


def _replay_stage_checks(tag: str, force, trace: dict, d: int, sr_tiles: int = 128) -> None:
    """18a (i) and (ii) on one replay: the concatenated sorted slices are
    the global stable (key, gid) sort, and the inverse exchange restores
    every row, bit for bit; each rank's ``short_range`` (its first
    ``sr_tiles`` target tiles, halo sources included), ``mesh_deposit`` and
    ``mesh_gather`` against their twins on the rank's operands.  Prints
    each rank's halo demand against ``h_cap``; returns whether one
    truncated."""
    keys, pm_k = torch.cat(trace["keys"]), torch.cat(trace["pm_k"])
    order = torch.argsort(keys, stable=True)
    sorted_ok = torch.equal(torch.cat(trace["ps_raw"]), pm_k[order]) and torch.equal(
        torch.cat(trace["gid_s"]).long(), order)
    back = exchange.inverse_exchange(ReplayGroup(d), trace["ps_raw"], trace["gid_s"], force.shard)
    check(sorted_ok and all(torch.equal(b, p) for b, p in zip(back, trace["pm_k"])),
          f"[18a] {tag} (i): the {d} sorted slices are the global stable (key, gid) sort of the "
          f"{keys.numel()} rows, and the inverse exchange restores every row, bit for bit")
    worst_sr, halo_slots = 0.0, 0
    box = force.box if force.periodic else None
    for r, sr in enumerate(trace["short_range"]):
        got = p3m.short_range_tiles(sr["ps"], sr["nbr_idx"], force.eps2, trace["sigma"], trace["rcut"], force.block,
                                    sr["nbr_mask"], box=box, nt=sr["nt"])
        m = min(sr_tiles, sr["nt"])
        want = p3m._short_range_tiles(sr["ps"], sr["nbr_idx"][:m], force.eps2, trace["sigma"], trace["rcut"],
                                      force.block, sr["nbr_mask"][:m], box)
        ok, e = _sr_agree(got[: m * force.block, :3], want[:, :3])
        worst_sr = max(worst_sr, e)
        halo_slots += int(((sr["nbr_idx"][:m] >= sr["nt"]) & (sr["nbr_mask"][:m] > 0)).sum())
        check(ok and bool(torch.isfinite(got).all()), f"[18a] {tag} (ii) rank {r}: short_range over [slice ; halo] "
              f"({sr['ps'].shape[0]} source rows) vs twin on its first {m} target tiles, {e:.3e} of the max")
    for leg, ms in enumerate(trace["mesh"]):
        for r, (c4, fm) in enumerate(ms["ops"]):
            rho = mc.deposit(c4, fm, force.grid, 3, force.periodic)
            if fm[:, 3].any():
                _deposit_agrees(f"[18a] {tag} (ii) rank {r} leg {leg}", c4, fm, force.grid, 3, rho,
                                mc.deposit_plain(c4, fm, force.grid, 3, force.periodic), force.periodic)
            else:  # a slice of padding rows alone
                check(not rho.any(), f"[18a] {tag} (ii) rank {r} leg {leg}: mesh_deposit of massless rows is 0")
            acc = mc.gather(ms["grids"], c4, fm, force.grid, 3, force.periodic, sorted_rows=True)
            e = rel_err(acc, mc.gather_plain(ms["grids"], c4, fm, force.grid, 3, force.periodic))
            check(e < 1e-5 and not acc[:, 3].any(), f"[18a] {tag} (ii) rank {r} leg {leg}: mesh_gather (sorted "
                  f"rows) vs twin {e:.3e} < 1e-5 of the max")
    demand = [int(sr["demand"]) for sr in trace["short_range"]]
    print(f"  [18a] {tag}: short_range vs twin worst {worst_sr:.3e} of the max ({halo_slots} live halo slots "
          f"checked); halo demand a rank {demand} against h_cap {force.h_cap} ({force.tiles_per} own tiles, "
          f"{force.nb} tiles, tile {force.block})", flush=True)
    return max(demand) > force.h_cap


def _net_kick(pm_real: torch.Tensor, acc: torch.Tensor) -> float:
    """``|sum m a| / max_c sum |m a_c|`` over real rows, in f64."""
    ma = pm_real[:, 3:4].double() * acc[:, :3].double()
    return float(ma.sum(0).abs().max() / ma.abs().sum(0).max())


def phase_sharded_mesh_replay(dev) -> None:
    """18a: sharded P3M replayed rank by rank in one process at full width
    on the kernel route, stage by stage: 12b's box (uniform box N =
    2,097,152, box 10, grid 128, k = 32, tile 256: the tiling and the
    selection of one device) at D = 2, 4, 8, each rank's assembled force
    against the single-device P3M (rtol 1e-4, atol 1e-5 of the max); 8b's
    two-galaxy scene (2,097,154 bodies, padded for 8 ranks to 8,200 tiles:
    another tiling than one device's 8,193, so the force is held by its
    momentum) at D = 8, the net kick <= 1e-5 of sum |m a|."""
    t0 = time.perf_counter()
    print(f"[18a sharded mesh replay] P3M ranks replayed in one process at full width ({_card()})", flush=True)
    cfg = SimConfig(method="p3m", pm_grid=128, p3m_nbr_k=32, boundary="periodic", box_size=BOX_L)
    pm_np, _, _ = make_preset("uniform-box", seed=0, G=G, n=BOX_N, box_size=BOX_L)
    full = init_state(pm_np, np.zeros_like(pm_np), device=dev).pos_mass
    want = p3m.accel_p3m(full, G, grid=cfg.pm_grid, eps2=cfg.eps2, nbr_k=cfg.p3m_nbr_k, boundary="periodic",
                         box_size=BOX_L)
    for d in REPLAY_D:
        t1 = time.perf_counter()
        force, acc, trace = replay_mesh(cfg, full, BOX_N, d)
        t_replay = time.perf_counter() - t1
        truncated = _replay_stage_checks(f"12b box D={d}", force, trace, d)
        got = torch.cat(acc)
        scale = float(want[:, :3].abs().max())
        err = (got[:, :3] - want[:, :3]).abs()
        ok = bool((err <= 1e-5 * scale + 1e-4 * want[:, :3].abs()).all())
        kick = _net_kick(full, got)
        if truncated:
            print(f"  [18a] 12b box D={d}: a halo truncates: the force is held by its momentum", flush=True)
            check(kick <= 1e-5, f"[18a] 12b box D={d} (iv): net kick {kick:.3e} <= 1e-5 of sum |m a|")
        else:
            check(ok and bool(torch.isfinite(got).all()),
                  f"[18a] 12b box D={d} (iii): the assembled force vs the single-device P3M, max |diff| "
                  f"{float(err.max()) / scale:.3e} of the max, within rtol 1e-4, atol 1e-5 of the max (net kick "
                  f"{kick:.3e}; replay {t_replay:.2f} s)")
        del trace
    cfg = SimConfig(method="p3m", pm_grid=128, p3m_nbr_k=32)
    pos_mass, _, n_real = _clustered(P3M_N, pad_count(P3M_N, PAD_GRANULE * 8), dev)
    force, acc, trace = replay_mesh(cfg, pos_mass, n_real, 8)
    _replay_stage_checks("8b two-galaxy D=8", force, trace, 8)
    got = torch.cat(acc)
    kick = _net_kick(pos_mass[:n_real], got[:n_real])
    check(bool(torch.isfinite(got).all()) and kick <= 1e-5,
          f"[18a] 8b two-galaxy N={n_real} D=8 ({force.nb} tiles, {force.tiles_per} a rank) (iv): net kick "
          f"{kick:.3e} <= 1e-5 of sum |m a| (the heavy split's {force.heavy_k} bodies summed over the ranks)")
    print(f"  18a: {time.perf_counter() - t0:.1f} s ({_card()})", flush=True)


def _sharded_cell(dev, tag: str, build, base: str, base_ms: float, chunks: int, chunk: int):
    """``build(**where)`` on ``default_mesh(1)`` (NCCL, one rank) through
    :func:`_mesh_run` (30 warm steps and the timed chunks: 50 steps), its
    ms/step beside ``base``'s one-device ms/step from this call; then from
    the state it reached one sharded step against one device's step, each
    array within rtol 1e-4, atol 1e-5 of its max.  Not bit for bit:
    ``mesh_deposit``'s float atomics add in no fixed order, so two
    one-device steps differ in the last bits too.  (Trajectories are not
    compared: a body whose last bit differs can change its Morton tile,
    and the truncated selection of these cells, the inherited ``nbr_k``
    fault, turns that into a different neighbour list.)"""
    torch.cuda.reset_peak_memory_stats()
    sim = build(mesh=SHARDED["x"])
    ms = _mesh_run(sim, f"{tag} Simulation(mesh=default_mesh(1)) N={sim.n_real}", chunks=chunks, chunk=chunk)
    st = sim.state
    steps = (sharded.make_sharded_step(sim.config, sim.n_pad, sim.n_real, SHARDED["x"]),
             make_step_fn(sim.config, sim.n_pad, sim.n_real, dev))
    got, want = (f(SimState(st.pos_mass.clone(), st.vel.clone(), st.accel.clone(), st.step), sim.dt, sim.G)
                 for f in steps)
    errs = []
    for a, b in zip((got.pos_mass, got.vel, got.accel), (want.pos_mass, want.vel, want.accel)):
        scale = float(b.abs().max())
        errs.append(float((a - b).abs().max()) / scale)
        check(bool(((a - b).abs() <= 1e-5 * scale + 1e-4 * b.abs()).all()), f"{tag}: step {st.step + 1} from "
              f"the same state, sharded vs one device within rtol 1e-4, atol 1e-5 of the max")
    print(f"{tag}: sharded, 1 rank {ms:.4f} ms/step, {base} (one device, this call) {base_ms:.4f} ms/step "
          f"({ms / base_ms - 1:+.2%}); step {st.step + 1} from the same state, max |diff| / max of pos_mass, vel, "
          f"accel against one device {[f'{e:.3e}' for e in errs]} ({_card()})", flush=True)
    return [(f"{tag} one step", lambda: sim.run(1, chunk=1))]


def _box_sim(method: str, **cfg):
    config = SimConfig(method=method, pm_grid=128, p3m_nbr_k=32, boundary="periodic", box_size=BOX_L, **cfg)
    return lambda **where: Simulation.from_preset("uniform-box", config, n=BOX_N, box_size=BOX_L, **where)


def phase_sharded_p3m_box(dev):
    """18b: 12b's periodic P3M through the sharded step at one rank."""
    return _sharded_cell(dev, "[18b sharded periodic p3m]", _box_sim("p3m"), "12b",
                         PERIODIC_MS.get("[12b periodic p3m]", float("nan")), 2, 10)


def phase_sharded_pm_box(dev):
    """18b: 12d's periodic PM through the sharded step at one rank."""
    return _sharded_cell(dev, "[18b sharded periodic pm]", _box_sim("pm"), "12d",
                         PERIODIC_MS.get("[12d periodic pm]", float("nan")), 2, 10)


def phase_sharded_cosmo(dev):
    """18c: 15b's comoving EdS P3M through the sharded step at one rank."""

    def build(**where):
        cfg = _cosmo_config("p3m", "eds", 128, 32, COSMO_L, G=G)
        sim = Simulation.from_preset("cosmo", cfg, n=COSMO_N1**3, box_size=COSMO_L, velocity="eds", **where)
        sim.dt = _eds_t_i(float(sim.state.pos_mass[:, 3].double().sum()), G, COSMO_L) / 100
        return sim

    return _sharded_cell(dev, "[18c sharded comoving eds p3m]", build, "15b",
                         PERIODIC_MS.get("[15b cosmo eds p3m]", float("nan")), 2, 10)


def phase_sharded_p3m(dev):
    """18d: 8b's isolated P3M (two-galaxy, the heavy split) through the
    sharded step at one rank."""
    cfg = SimConfig(method="p3m", pm_grid=128, p3m_nbr_k=32)
    return _sharded_cell(dev, "[18d sharded p3m]",
                         lambda **where: Simulation.from_preset("two-galaxy", cfg, n=P3M_N, **where), "8b",
                         MAIN.get("phase 8b", float("nan")), 2, 10)


# ------------------------------------------------------ 19: sharded render
RENDER_D = (2, 4, 8)
SERVE_MS: dict[str, float] = {}  # 16b's and 19c's frame intervals, host clock, this call


def render_frames() -> dict:
    """19a's frames: two-galaxy N = 40,002 at serve's 960x720 and 16a's
    N = 500,010 at 1920x1080: (pos_mass, vel, camera, width, height)."""
    cfg = SimConfig()
    pm, vel, target = make_preset("two-galaxy", seed=cfg.seed, G=cfg.G, size_factor=cfg.size_factor)
    return {"two-galaxy N=40,002 960x720": (pm, vel, Camera(target=target), SERVE_W, SERVE_H),
            "N=500,010 1920x1080": (*render_scene(500_010, 0), Camera(target=np.zeros(3), radius=5.0), 1920, 1080)}


def phase_sharded_render_replay(dev) -> None:
    """19a: the sharded render of D = 2, 4 and 8 ranks replayed in one
    process (``ReplayGroup``): each rank's prep and ``splat_resolve`` on its
    shard of the state padded as a D-rank engine pads it (the padding rows
    in the last shard), one ``amin`` of the flipped words; the merged words
    bit-equal to one launch on the whole state's real rows.  At 1080p, D =
    8, a rank's frame (prep + resolve of its shard), the replayed merge
    (D - 1 minima of 8 B/px and the flips, on one card) and one device's
    frame, by CUDA events."""
    from nbody3d_tpu_torch.render.sharded import make_sharded_render, merge_words, shard_words

    print(f"[19a sharded render replay] D = 2, 4, 8 ranks' splat_resolve and the amin merge ({_card()})", flush=True)
    t0 = time.perf_counter()
    for name, (pm_np, vel_np, cam, w, h) in render_frames().items():
        n = pm_np.shape[0]
        pm, vel = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pm_np, vel_np))
        prep = rasterize.prep_device(pm, vel, cam, w, h)
        want = resolve.splat_resolve(*prep, width=w, height=h)
        lit = int((want != resolve.MISS).sum())
        for d in RENDER_D:
            n_pad = pad_count(n, PAD_GRANULE * d)
            st = init_state(pm_np, vel_np, n_pad=n_pad, device=dev)
            shards = list(st.pos_mass.view(d, -1, 4)), list(st.vel.view(d, -1, 4))
            render = make_sharded_render(ReplayGroup(d), n_pad, n, width=w, height=h)
            got = render.words(*shards, cam)
            shard = n_pad // d
            check(torch.equal(got, want) and lit > 0,
                  f"[19a] {name} D={d}: n_pad {n_pad}, shard {shard}, the last shard's {n_pad - n} padding rows "
                  f"masked; the merged words bit-equal to one launch on the {n} real rows ({lit} px lit)")
        if w != 1920:
            continue
        d = 8
        n_pad = pad_count(n, PAD_GRANULE * d)
        st = init_state(pm_np, vel_np, n_pad=n_pad, device=dev)
        group = ReplayGroup(d)
        preps = [rasterize.prep_device(p, v, cam, w, h) for p, v in zip(st.pos_mass.view(d, -1, 4), st.vel.view(d, -1, 4))]
        words = [shard_words(p, r, n, width=w, height=h) for r, p in enumerate(preps)]
        reps = 10
        rank_ms = [cuda_ms(lambda r=r: shard_words(rasterize.prep_device(st.pos_mass.view(d, -1, 4)[r],
                                                                          st.vel.view(d, -1, 4)[r], cam, w, h),
                                                   r, n, width=w, height=h), reps) for r in range(d)]
        merge_ms = cuda_ms(lambda: merge_words(group, words), reps)
        one_ms = cuda_ms(lambda: resolve.splat_resolve(*rasterize.prep_device(pm, vel, cam, w, h), width=w, height=h),
                         reps)
        mean_rank = statistics.mean(rank_ms)
        print(f"  [19a] {name} D=8, CUDA events, mean of {reps}: a rank's frame (prep + splat_resolve of its "
              f"{n_pad // d} rows) {min(rank_ms):.4f}-{max(rank_ms):.4f} ms (mean {mean_rank:.4f}); the replayed "
              f"merge ({d - 1} minima of {w * h * 8:,} B and the flips, one card) {merge_ms:.4f} ms, "
              f"{merge_ms / (mean_rank + merge_ms):.4f} of a rank's frame + merge; one device's frame of the "
              f"{n} rows {one_ms:.4f} ms ({_card()})", flush=True)
    print(f"  19a: {time.perf_counter() - t0:.1f} s", flush=True)


def host_syncs(fn) -> list[str]:
    """The host syncs ``fn()`` makes, as ``torch.cuda.set_sync_debug_mode
    ("warn")`` names them."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]


def phase_sharded_render_engine(dev):
    """19b: ``Simulation(mesh=default_mesh(1))`` (NCCL, one rank) on the
    two-galaxy state at 960x720, after a Morton re-sort (2 steps,
    ``morton_every=1``) and after a sharded P3M step (grid 128, k = 32):
    ``render_frame`` with ``auto`` (the sharded render: the rank's
    ``splat_resolve`` and the all-reduce), ``host`` and ``device`` (the
    gathered rows), and each resolve's begin, a chunk after it and its
    finish; the padding rows' mass 0 before and after the chunk; no host
    sync in the ``auto`` begin (``set_sync_debug_mode("warn")``).  The
    window holds the mesh's calls alone.  After it: each frame bit-equal to
    one device's frame of the same rows, one device's begin without a host
    sync, the sharded frame's time beside one device's, and its stages."""
    from nbody3d_tpu_torch.render.rasterize import RESOLVES

    cfg0 = SimConfig()
    pm_np, vel_np, target = make_preset("two-galaxy", seed=cfg0.seed, G=cfg0.G, size_factor=cfg0.size_factor)
    cam, frame = Camera(target=target), dict(width=SERVE_W, height=SERVE_H)
    cases = []
    for label, cfg, steps in (("after a Morton re-sort", SimConfig(morton_every=1), 2),
                              ("after a sharded P3M step", SimConfig(method="p3m", pm_grid=128, p3m_nbr_k=32), 1)):
        sim = Simulation(cfg, pm_np, vel_np, mesh=SHARDED["x"])
        sim.run(steps, chunk=1)
        arrays = sim.arrays()
        pad = float(sim.global_state().pos_mass[sim.n_real:, 3].abs().max())
        got = {res: sim.render_frame(camera=cam, resolve=res, **frame) for res in RESOLVES}
        handles = {res: sim.render_frame_begin(cam, resolve=res, **frame) for res in RESOLVES}
        token = sim.run_async(1)
        piped = {res: sim.render_frame_finish(handles[res]) for res in RESOLVES}
        sim.wait_chunk(token)
        pad_after = float(sim.global_state().pos_mass[sim.n_real:, 3].abs().max())
        check(pad == 0.0 and pad_after == 0.0 and sim.step_count == steps + 1,
              f"[19b] {label}: the {sim.n_pad - sim.n_real} padding rows stay at the tail (mass {pad}, {pad_after})")
        cases.append((label, cfg, arrays, got, piped))
    begun = []
    syncs = host_syncs(lambda: begun.append(sim.render_frame_begin(cam, **frame)))
    sim.render_frame_finish(begun[0])
    check(not syncs, f"[19b] render_frame_begin('auto') on the mesh makes no host sync: {syncs or 'none'}")

    def against_one_device():
        """One device's frames of the rows each case rendered, its begin's
        syncs, and the frames' times and stages."""
        for label, cfg, arrays, got, piped in cases:
            one = Simulation(cfg, *arrays, device=dev)
            for res in RESOLVES:
                want = one.render_frame(camera=cam, resolve=res, **frame)
                check(np.array_equal(got[res], want) and want.any(),
                      f"[19b] {label}: render_frame(resolve={res!r}) on the 1-rank mesh == one device's, bit for bit")
                check(np.array_equal(piped[res], want),
                      f"[19b] {label}: begin({res!r}), a chunk enqueued after it, finish == one device's frame")
        one.render_frame_finish(one.render_frame_begin(cam, **frame))
        syncs_one = host_syncs(lambda: begun.append(one.render_frame_begin(cam, **frame)))
        one.render_frame_finish(begun[1])
        check(not syncs_one, f"[19b] render_frame_begin('auto') on one device makes no host sync: "
                             f"{syncs_one or 'none'}")
        ms = {}
        for who, s in (("mesh", sim), ("one", one), ("mesh", sim), ("one", one)):  # in turns
            ms.setdefault(who, []).append(statistics.median(host_ms(lambda: s.render_frame(camera=cam, **frame))
                                                            for _ in range(3)))
        print(f"  [19b] the 960x720 auto frame, host clock, synced, median of 3, in turns: sharded (1 rank: prep, "
              f"splat_resolve, the all-reduce of {SERVE_W * SERVE_H * 8:,} B) {ms['mesh']} ms, one device "
              f"{ms['one']} ms ({_card()})", flush=True)
        # The sharded frame's stages alone, host clock, synced, median of 5.
        from nbody3d_tpu_torch.render.sharded import merge_words, shard_words

        group = exchange.DistGroup(0, 1)
        pm, vel = sim.state.pos_mass, sim.state.vel
        prep = rasterize.prep_device(pm, vel, cam, SERVE_W, SERVE_H)
        words = shard_words(prep, 0, sim.n_real, width=SERVE_W, height=SERVE_H)
        merged = merge_words(group, [words])
        stage = {
            "prep": lambda: rasterize.prep_device(pm, vel, cam, SERVE_W, SERVE_H),
            "mask + splat_resolve": lambda: shard_words(prep, 0, sim.n_real, width=SERVE_W, height=SERVE_H),
            "merge (flips + all_reduce MIN)": lambda: merge_words(group, [words]),
            "all_reduce MIN alone": lambda: dist.all_reduce(words.clone(), op=dist.ReduceOp.MIN),
            "image + copy to host": lambda: resolve.buffer_image(merged, width=SERVE_W, height=SERVE_H).cpu(),
        }
        took = {k: statistics.median(host_ms(f) for _ in range(5)) for k, f in stage.items()}
        print("  [19b] the sharded frame's stages, host clock, synced, median of 5: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in took.items()) + f" ({_card()})", flush=True)

    return [against_one_device]


def phase_sharded_serve(dev):
    """19c: ``LiveViewer`` on ``Simulation(mesh=default_mesh(1))`` (NCCL,
    one rank; the op records over the gloo side group to no follower) on
    16b's configuration, on an ephemeral port in this process, every HTTP
    call with a timeout: ten pipelined frames, /frame.jpg, /stats, pause and
    the paused frame against the encode of ``render_frame`` at the same
    camera, export then import (bit-equal), the imported sim set running,
    2 s of frames (the interval beside 16b's from this call), regenerate,
    stop; after the window a profiled frame, the viewer's pipelined frame
    on the mesh and on one device in turns (no loop thread), the host's
    enqueue of a chunk on each, and an op record's broadcast."""
    from nbody3d_tpu_torch import viewer as viewer_mod
    from nbody3d_tpu_torch.render.jpeg import encode_jpeg
    from nbody3d_tpu_torch.viewer import LiveViewer, control_group

    sim = Simulation.from_preset("two-galaxy", SimConfig(), mesh=SHARDED["x"])
    v = LiveViewer(sim, width=SERVE_W, height=SERVE_H, steps_per_frame=SERVE_K, side=control_group())
    server = v.make_server("127.0.0.1", 0)
    port = server.server_address[1]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    print(f"[19c sharded serve] LiveViewer on a 1-rank mesh, two-galaxy N={sim.n_real}, {SERVE_W}x{SERVE_H}, "
          f"{SERVE_K} steps a frame, http://127.0.0.1:{port}/", flush=True)

    def sample():
        with v._sim_lock:
            return v.sim.step_count, v.chunks_done, v._frames_done, time.perf_counter()

    try:
        v.start()
        check(_until(lambda: v.chunks_done >= 10), f"[19c] ten pipelined frames ({v.chunks_done})")
        st, body = _http(port, "/frame.jpg")
        stats = json.loads(_http(port, "/stats")[1])
        check(st == 200 and _jpeg_ok(body) and _jpeg_size(body) == (SERVE_W, SERVE_H) and stats["n"] == 40_002,
              f"[19c] /frame.jpg {st}, {_jpeg_size(body)}, {len(body):,} B; /stats n {stats['n']}")
        check(_http(port, "/control?pause=1")[0] == 204 and v.sim.paused, "[19c] /control?pause=1")
        frames = v._frames_done
        _until(lambda: v._frames_done >= frames + 2)
        cam, w, h = v._snapshot()
        st, served = _http(port, "/frame.jpg")
        with v._sim_lock:
            want = encode_jpeg(v.sim.render_frame(camera=cam, width=w, height=h), v.quality)
        check(st == 200 and served == want, "[19c] paused /frame.jpg == encode_jpeg(render_frame(same camera))")
        st, npz = _http(port, "/export.npz")
        st2, _ = _http(port, "/import.npz", npz)
        with np.load(io.BytesIO(npz)) as z, v._sim_lock:
            same = all(np.array_equal(z[k], a) for k, a in zip(("pos_mass", "vel", "accel"), v.sim.arrays()))
            same &= int(z["step"]) == v.sim.step_count and v.sim.mesh is SHARDED["x"]
        check(st == 200 and st2 == 204 and same, f"[19c] /export.npz ({len(npz):,} B) then POST /import.npz: the "
                                                 "imported sharded state equals the exported one bit for bit")
        check(_http(port, "/control?logdt=-3.8")[0] == 204 and not v.sim.paused, "[19c] the imported sim runs")
        c0 = v.chunks_done
        _until(lambda: v.chunks_done >= c0 + 2)
        a = sample()
        time.sleep(2.0)
        b = sample()
        interval = SERVE_MS["19c"] = (b[3] - a[3]) / max(b[2] - a[2], 1) * 1e3
        check(b[1] > a[1] and b[0] - a[0] == SERVE_K * (b[1] - a[1]),
              f"[19c] {b[1] - a[1]} pipelined frames in {b[3] - a[3]:.3f} s advanced {b[0] - a[0]} steps")
        check(_http(port, "/control?regenerate=1")[0] == 204 and v.sim.n_real == 40_002 and v.sim.mesh is not None,
              f"[19c] /control?regenerate=1: N={v.sim.n_real} on the mesh")
        c0 = v.chunks_done
        check(_until(lambda: v.chunks_done >= c0 + 3, 30), f"[19c] the regenerated sim steps ({v.sim.step_count})")
    finally:
        v.stop()
        server.shutdown()
        server.server_close()
        serving.join(timeout=10)
    check(v.error is None and not v._thread.is_alive() and not v._followers,
          f"[19c] loop and server stopped, the stop op sent, no loop error ({v.error!r})")
    base = SERVE_MS.get("16b", float("nan"))
    print(f"  [19c] frame interval on the 1-rank mesh {interval:.3f} ms vs one device (16b, this call) {base:.3f} ms "
          f"({interval / base - 1:+.2%}); host clock, 2 s of pipelined frames ({_card()})", flush=True)
    s = v.sim

    def frame():
        handle = s.render_frame_begin(cam, width=SERVE_W, height=SERVE_H)
        token = s.run_async(SERVE_K)
        s.render_frame_finish(handle)
        s.wait_chunk(token)

    def in_turns(rounds: int = 3, frames: int = 10):
        """The viewer's own pipelined frame (``LiveViewer.pipelined_frame``:
        the op record on the mesh, begin, chunk, finish, JPEG, wait), no loop
        thread and no server, on the mesh and on one device in turns."""
        one = Simulation.from_preset("two-galaxy", SimConfig(), device=dev)
        viewers = {"mesh": LiveViewer(s, width=SERVE_W, height=SERVE_H, steps_per_frame=SERVE_K,
                                      side=control_group()),
                   "one device": LiveViewer(one, width=SERVE_W, height=SERVE_H, steps_per_frame=SERVE_K)}
        ms: dict[str, list[float]] = {k: [] for k in viewers}
        for _ in range(rounds):
            for k, viewer in viewers.items():
                viewer.pipelined_frame()
                t0 = time.perf_counter()
                for _ in range(frames):
                    viewer.pipelined_frame()
                ms[k].append((time.perf_counter() - t0) / frames * 1e3)
        m, o = statistics.median(ms["mesh"]), statistics.median(ms["one device"])
        print(f"  [19c] the viewer's pipelined frame in turns ({rounds} rounds of {frames}, host clock, no loop "
              f"thread): 1-rank mesh {[round(x, 3) for x in ms['mesh']]} ms, one device "
              f"{[round(x, 3) for x in ms['one device']]} ms; medians {m:.3f} vs {o:.3f} ({m / o - 1:+.2%}) "
              f"({_card()})", flush=True)

        def enqueue_ms(sim) -> float:
            """The host's time to enqueue a chunk (``run_async``), the stream idle before it."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            token = sim.run_async(SERVE_K)
            t = (time.perf_counter() - t0) * 1e3
            sim.wait_chunk(token)
            return t

        enq = {k: [] for k in viewers}
        for _ in range(5):
            for k, viewer in viewers.items():
                enq[k].append(enqueue_ms(viewer.sim))
        record = {"op": "frame", "runtime": (s.dt, s.G, None), "camera": cam.to_dict(), "width": SERVE_W,
                  "height": SERVE_H, "resolve": "auto", "k": SERVE_K, "diagnostics": False}
        side = viewers["mesh"]._side
        announce = statistics.median(host_ms(lambda: viewer_mod._broadcast(record, side)) for _ in range(5))
        print(f"  [19c] the host's enqueue of a chunk of {SERVE_K} steps, in turns, median of 5: 1-rank mesh "
              f"{statistics.median(enq['mesh']):.3f} ms, one device {statistics.median(enq['one device']):.3f} ms; "
              f"an op record's broadcast over the gloo side group (1 rank) {announce:.3f} ms ({_card()})", flush=True)

    return [(f"19c one pipelined frame on the 1-rank mesh ({SERVE_W}x{SERVE_H}, {SERVE_K} steps)", frame), in_turns]


def phase_dryrun(dev) -> None:
    """19d: ``dryrun_multichip(1, "cuda")``: one spawned NCCL rank runs one
    sharded step of the JAX dryrun's configurations (the 2-D one needs 4
    ranks) and the sharded render at 96x64; the kernels that rank launched.
    This process launches none."""
    from nbody3d_tpu_torch.parallel.dryrun import configs, dryrun_multichip

    t0 = time.perf_counter()
    report = dryrun_multichip(1, "cuda")
    launched = report["launches_by_rank"][0]
    want = {"force_exact", "mesh_deposit", "mesh_gather", "short_range", "splat_resolve"}
    check(report["steps"] == {name: 1 for name in configs(1)} and report["frame"]["shape"] == [64, 96]
          and report["frame"]["n_uncovered"] == 0 and want <= set(launched),
          f"[19d] dryrun_multichip(1, 'cuda') in {time.perf_counter() - t0:.1f} s: steps {report['steps']}, frame "
          f"{report['frame']}; the rank launched {json.dumps(launched)}")


SHARDED_PATHS = (
    ("phase 17b (sharded ring path, 1 rank)", phase_sharded_ring, ("force_exact",)),
    ("phase 17c (sharded ringsym path, 1 rank)", phase_sharded_ringsym, SYM_FORCE),
    ("phase 17d (sharded gather and 2d paths, 1 rank)", phase_sharded_gather_2d, ("force_exact", "fused_step_exact")),
    ("phase 18b (sharded periodic P3M path, 1 rank)", phase_sharded_p3m_box, MESH_KERNELS),
    ("phase 18b (sharded periodic PM path, 1 rank)", phase_sharded_pm_box, ("mesh_deposit", "mesh_gather")),
    ("phase 18c (sharded comoving EdS P3M path, 1 rank)", phase_sharded_cosmo, MESH_KERNELS),
    ("phase 18d (sharded P3M path, 1 rank)", phase_sharded_p3m, MESH_KERNELS),
    ("phase 19b (sharded render path, 1 rank)", phase_sharded_render_engine,
     ("force_exact", "splat_resolve") + MESH_KERNELS),
    ("phase 19c (sharded serve loop, 1 rank)", phase_sharded_serve, ("force_exact", "splat_resolve")),
)


def _extras(r: dict) -> str:
    """A row's all-pairs bound and shares, and the parent's time, where it has them."""
    out = ""
    if "bound_all_pairs_ms" in r:
        out += (f"  all-pairs bound {r['bound_all_pairs_ms']:.4f} ms ({r['bound_all_pairs_by']}), in rcut "
                f"{r['in_rcut_share']:.4f}, through the votes {r['vote_share']:.4f} of the pairs")
    if "parent_ms" in r:
        out += f"  parent {r['parent_ms']:.4f} ms, this {r['this_ms']:.4f} ms (in turns)"
    return out


# Keys of a row that the kernels line carries where the row has them.
ROW_EXTRAS = ("bound_all_pairs_ms", "bound_all_pairs_by", "in_rcut_share", "vote_share", "parent_ms", "this_ms")


def _print_times(out: dict[str, dict]) -> None:
    for name, r in out.items():
        print(f"  {name:16s} {r['shape']:34s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  max-abs err {r['max_abs_err']:.3e}"
              + (f"  library {r['library_ms']:.4f} ms" if r.get("library_ms") is not None else "")
              + _extras(r) + (f"  [{r['note']}]" if "note" in r else ""), flush=True)


SYM = ("sym_diag_prep", "sym_hops", "sym_epilogue")
VJP_SYM = ("vjp_sym_diag", "vjp_sym_hops", "vjp_combine")
# The main paths, each with the kernels it runs; a kernel's "launches" is
# its sum over these windows, phase 7b's (its entry is made in main,
# which knows the output directory), the live viewer's, 16b, and phase
# 17's (``SHARDED_PATHS``, run inside ``OneRankGroup``).
PATHS = (
    ("phase 4 (exact path)", phase_exact, ("fused_step_exact",)),
    ("phase 5 (sym path)", phase_sym, SYM),
    ("phase 6a (sym gradient path)", phase_grad_sym, SYM + VJP_SYM),
    ("phase 6b (exact gradient path)", phase_grad_exact, ("force_exact", "fused_step_exact") + VJP_SYM),
    ("phase 8b (P3M path)", phase_p3m, MESH_KERNELS),
    ("phase 8d (PM path)", phase_pm, ("mesh_deposit", "mesh_gather")),
    ("phase 9b (P3M gradient path)", phase_grad_p3m, MESH_GRAD),
    ("phase 9c (PM gradient path)", phase_grad_pm, ("mesh_deposit", "mesh_gather")),
    ("phase 10b (unfused sym path, yoshida4)", phase_sym_yoshida4, SYM_FORCE),
    ("phase 10b (unfused sym path, verlet)", phase_sym_unfused_verlet, SYM_FORCE),
    ("phase 10c (fused exact path, the composed route beside it)", phase_fused_exact, ("fused_step_exact", "force_exact")),
    ("phase 11b (fast path, sphere)", phase_fast_sphere, ("fused_step_fast",)),
    ("phase 11c (fast path, two-galaxy)", phase_fast_two_galaxy, ("fused_step_fast",)),
    ("phase 11c (composed fast route)", phase_fused_fast, ("force_fast",)),
    ("phase 12b (periodic P3M path)", phase_periodic_p3m, MESH_KERNELS),
    ("phase 12b (periodic P3M path, interlaced)", phase_periodic_p3m_interlaced, MESH_KERNELS),
    ("phase 12d (periodic PM path)", phase_periodic_pm, ("mesh_deposit", "mesh_gather")),
    ("phase 13b (periodic P3M gradient path)", phase_periodic_grad_p3m, MESH_GRAD),
    ("phase 13b (periodic P3M gradient path, interlaced)", phase_periodic_grad_p3m_interlaced, MESH_GRAD),
    ("phase 13c (periodic PM gradient path)", phase_periodic_grad_pm, ("mesh_deposit", "mesh_gather")),
    ("phase 14b (macro sym path, 2M)", phase_macro_sym, SYM_FORCE + ("pair_sym",)),
    ("phase 15b (comoving EdS P3M path)", phase_cosmo_p3m, MESH_KERNELS),
    ("phase 15b (comoving ΛCDM P3M path)", phase_cosmo_p3m_lcdm, MESH_KERNELS),
    ("phase 15b (comoving EdS PM path)", phase_cosmo_pm, ("mesh_deposit", "mesh_gather")),
)
PERIODIC_PATHS = tuple(path for path, _, _ in PATHS + SHARDED_PATHS
                       if path.startswith(("phase 12", "phase 13", "phase 15", "phase 18b", "phase 18c")))
RENDER_PATH = "phase 7b (render + checkpoint path)", ("fused_step_exact", "splat_resolve")
SERVE_PATH = "phase 16b (live viewer)", phase_serve, ("fused_step_exact", "splat_resolve")
# Runs off the main paths, each in a window of its own: the full-grid VJP
# route (vjp_full's launches are read here) and the N = 4,096 cross-check.
SIDE = (
    ("phase 6c (full-grid VJP route)", phase_grad_full, ("force_exact", "vjp_full")),
    ("phase 6d (cross-check)", phase_grad_crosscheck, ("force_exact", "vjp_full") + SYM + VJP_SYM),
    ("phase 8c (P3M accuracy probe and run)", phase_p3m_probe, ("force_exact",) + MESH_KERNELS),
    ("phase 8e (mesh cross-check)", phase_mesh_crosscheck, MESH_KERNELS),
    ("phase 9d (mesh gradient cross-check)", phase_mesh_grad_crosscheck, MESH_GRAD),
    ("phase 10d (unfused sym gradient cross-check)", phase_sym_grad_crosscheck, SYM_FORCE + VJP_SYM),
    ("phase 10e (uncentred sym route)", phase_uncentred_sym, ("sym_diag", "sym_hops", "sym_combine", "sym_diag_prep")),
    ("phase 11d (fast gradient cross-check)", phase_fast_grad_crosscheck, ("force_fast",) + VJP_SYM),
    ("phase 12c (periodic accuracy, run and cross-check)", phase_periodic_accuracy, MESH_KERNELS),
    ("phase 13d (periodic gradient cross-check)", phase_periodic_grad_crosscheck, MESH_GRAD),
    ("phase 14d (macro sym gradient cross-check)", phase_macro_grad_crosscheck, SYM_FORCE + ("pair_sym",) + VJP_SYM),
    ("phase 15c (analysis of 15b's end state)", phase_cosmo_analysis, ("mesh_deposit",)),
)
FULL_ROUTE = SIDE[0][0]
# Kernels on no main path: their launches come from these side windows.
LAUNCHES_FROM = {"vjp_full": FULL_ROUTE, "sym_diag": "phase 10e (uncentred sym route)"}


# --------------------------------------------------- 20: the host C modules
def _in_turns(fns: dict, rounds: int = 2, reps: int = 3) -> dict[str, list[float]]:
    """name: the medians of ``reps`` host-clock calls (ms, synced), one a
    round, the functions called in turns."""
    ms: dict[str, list[float]] = {}
    for _ in range(rounds):
        for name, fn in fns.items():
            ms.setdefault(name, []).append(round(statistics.median(host_ms(fn) for _ in range(reps)), 3))
    return ms


def phase_native_raster(dev) -> None:
    """20a: ``native/_raster.c`` on its two paths.  The quantized frame's
    large splats at 16a's N = 500,010 1920x1080 (bit-equal to the
    ``_stamp_large`` twin on the same words and splats, then the frame with
    either stamp in turns), and the ``host`` frame at 7c's N = 500,010
    1920x1080 and serve's two-galaxy 960x720 (bit-equal to
    ``resolve_keys_plain`` on the same host prep, both times)."""
    print(f"[20a host disc stamp] native/_raster.c ({_card()}; host clock on the card machine's host)", flush=True)
    frames = render_frames()
    pm, vel, cam, w, h = frames["N=500,010 1920x1080"]
    prep = _prep(pm, vel, cam, dict(width=w, height=h), dev)
    words = resolve.quantized_scatter(*prep, width=w, height=h).cpu()
    large = resolve.quantized_large(*prep)
    n_large = large[0].shape[0]
    got = resolve.quantized_frame(words, large, width=w, height=h)
    want = resolve.quantized_frame_plain(words, large, width=w, height=h)
    check(torch.equal(got, want) and n_large > 0,
          f"[20a] quantized N=500,010 1920x1080: the C stamp's frame == _stamp_large's ({n_large} large splats)")
    stamp = _in_turns({"C": lambda: resolve.quantized_frame(words, large, width=w, height=h),
                       "twin": lambda: resolve.quantized_frame_plain(words, large, width=w, height=h)})
    pm_d, vel_d = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pm, vel))
    c_frame = resolve.quantized_frame

    def frame_with(fn):
        resolve.quantized_frame = fn
        try:
            return rasterize.render_points(pm_d, vel_d, cam, width=w, height=h, resolve="device")
        finally:
            resolve.quantized_frame = c_frame

    check(np.array_equal(frame_with(c_frame), frame_with(resolve.quantized_frame_plain)),
          "[20a] render_points(resolve='device') with either stamp: the same image")
    frame = _in_turns({"C": lambda: frame_with(c_frame), "twin": lambda: frame_with(resolve.quantized_frame_plain)})
    print(f"  [20a] quantized N=500,010 1920x1080, {n_large} large splats, median of 3 a round, in turns: "
          f"frame with the C stamp {frame['C']} ms, with the _stamp_large twin {frame['twin']} ms; the stamp alone "
          f"{stamp['C']} ms (C) vs {stamp['twin']} ms (twin)", flush=True)
    for name, sf in (("N=500,010 1920x1080", 1000.0), ("two-galaxy N=40,002 960x720", SimConfig().size_factor)):
        pm, vel, cam, w, h = frames[name]
        t0 = time.perf_counter()
        cx, cy, keys, r = rasterize._prep_host(pm, vel, cam, w, h, sf, 64, "magnitude")
        prep_ms = (time.perf_counter() - t0) * 1e3
        twin_in = [torch.from_numpy(a) for a in (cx, cy, keys.view(np.int64), r)]
        check(torch.equal(rasterize.resolve_host(cx, cy, keys, r, width=w, height=h),
                          resolve.resolve_keys_plain(*twin_in, width=w, height=h)),
              f"[20a] host resolve {name} ({cx.shape[0]} visible splats): C == resolve_keys_plain")
        ms = _in_turns({"C": lambda: rasterize.resolve_host(cx, cy, keys, r, width=w, height=h),
                        "twin": lambda: resolve.resolve_keys_plain(*twin_in, width=w, height=h),
                        "frame": lambda: rasterize.render_points(pm, vel, cam, width=w, height=h, size_factor=sf,
                                                                 resolve="host")},
                       reps=1 if cx.shape[0] > 100_000 else 3)
        print(f"  [20a] host frame {name}: the f64 prep {prep_ms:.1f} ms; the resolve in turns: C {ms['C']} ms, "
              f"resolve_keys_plain {ms['twin']} ms; render_points(resolve='host') {ms['frame']} ms", flush=True)


def phase_native_json(dev) -> None:
    """20b: reference-JSON checkpoints through ``native/_fastjson.c`` at
    8d's PM state (N = 2,097,152): save, load, the round trip bit for bit,
    ``json.loads`` of the file, and the ``json.dump`` writer at 500,000."""
    from nbody3d_tpu_torch.utils import checkpoint

    print(f"[20b float32 JSON codec] native/_fastjson.c ({_card()}; host clock on the card machine's host)",
          flush=True)
    sim = MESH_SIMS["pm"]
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "pm.json"
        save_s = host_ms(lambda: sim.save(str(path))) / 1e3
        mb = path.stat().st_size / 1e6
        box = []
        load_s = host_ms(lambda: box.append(Simulation.load(str(path), sim.config, device=dev))) / 1e3
        back = box[0]
        same = all(np.array_equal(a.view(np.uint32), b.view(np.uint32)) for a, b in zip(back.arrays(), sim.arrays()))
        raw = path.read_bytes()
        meta = json.loads(b"{" + raw[raw.rindex(b', "camera": ') + 2:])  # the keys after the arrays
        cam = Camera(target=sim.camera_target).to_dict()
        meta_ok = (meta["G"] == f"{np.log10(sim.G):.2f}" and back.G == 10.0 ** float(meta["G"])
                   and meta["dt"] == back.dt == sim.dt and meta["step"] == back.step_count == sim.step_count
                   and meta["nBodies"] == back.n_real == sim.n_real
                   and meta["camera"] == back.loaded_camera.to_dict() == cam)
        check(same and meta_ok, f"[20b] N={sim.n_real:,} .json round trip: arrays bit-equal, G string "
                                f"{meta['G']!r}, dt, step {back.step_count}, camera")
        t0 = time.perf_counter()
        doc = json.loads(raw)
        loads_same = all(np.array_equal(np.asarray(doc[k], np.float32).reshape(-1, 4).view(np.uint32),
                                        a.view(np.uint32)) for k, a in zip(("bodies", "vel", "accel"), sim.arrays()))
        loads_s = time.perf_counter() - t0
        del doc
        check(loads_same, f"[20b] json.loads of the file: the same float32 arrays ({loads_s:.2f} s)")
        del raw, back, box
        small = Simulation(SimConfig(), *(a[:500_000] for a in sim.arrays()), device="cpu")
        small.dt, small.G = sim.dt, sim.G
        c_s = host_ms(lambda: checkpoint.save_reference_json(str(path), small)) / 1e3
        c_mb = path.stat().st_size / 1e6
        t0 = time.perf_counter()
        data = {k: [float(v) for v in a.reshape(-1)] for k, a in zip(("bodies", "vel", "accel"), small.arrays())}
        with open(path, "w") as f:
            json.dump({**data, **{k: meta[k] for k in ("camera", "G", "dt", "step")}, "nBodies": small.n_real}, f)
        dump_s, dump_mb = time.perf_counter() - t0, path.stat().st_size / 1e6
        del data
    print(f"  [20b] N={sim.n_real:,}: save {save_s:.3f} s, load {load_s:.3f} s (to the card), {mb:.1f} MB; "
          f"N=500,000: the C codec's save {c_s:.3f} s ({c_mb:.1f} MB), the json.dump writer "
          f"{dump_s:.3f} s ({dump_mb:.1f} MB)", flush=True)


# ------------------------------------------ 21: the last pieces of the JAX package
def _returns(fn, what: str, timeout: float = 120.0):
    """``fn()`` in a daemon thread: its result, after a check that it
    returned within ``timeout`` seconds (a collective that waited on a peer
    would not) and raised nothing."""
    box: dict = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as e:  # handed to the caller's check
            box["err"] = e

    t0 = time.perf_counter()
    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(timeout)
    sec = time.perf_counter() - t0
    check(not th.is_alive() and "err" not in box,
          f"[21a] {what} returned in {sec:.3f} s (limit {timeout:g} s){': ' + repr(box['err']) if 'err' in box else ''}")
    return box.get("out"), sec


def phase_checkpoint_dir(dev) -> None:
    """21a: the checkpoint directory at 8d's PM state (N = 2,097,152): the
    round trip to the card bit for bit, dt, G, step and camera; save, load
    and MB beside ``.npz`` in turns; ``peek_config``; the same state saved
    and loaded on a one-rank NCCL mesh, bit-equal to one device's
    directory."""
    from nbody3d_tpu_torch.utils import checkpoint

    print(f"[21a checkpoint directory] torch.distributed.checkpoint {torch.__version__} ({_card()}; host clock on "
          f"the card machine's host)", flush=True)
    sim = MESH_SIMS["pm"]
    want = sim.arrays()
    with tempfile.TemporaryDirectory() as tmp:
        d, z, dm = (pathlib.Path(tmp) / name for name in ("pm_ckpt", "pm.npz", "pm_mesh_ckpt"))
        loaded: dict = {}
        ms = _in_turns({
            "dir save": lambda: sim.save(str(d)),
            "npz save": lambda: sim.save(str(z)),
            "dir load": lambda: loaded.__setitem__("dir", Simulation.load(str(d), device=dev)),
            "npz load": lambda: loaded.__setitem__("npz", Simulation.load(str(z), device=dev)),
        }, rounds=2, reps=1)
        peek = _in_turns({"peek": lambda: checkpoint.peek_config(str(d))}, rounds=1, reps=3)["peek"]
        mb_dir = sum(f.stat().st_size for f in d.iterdir()) / 1e6
        mb_npz = z.stat().st_size / 1e6
        back = loaded["dir"]
        same = all(np.array_equal(a.view(np.uint32), b.view(np.uint32)) for a, b in zip(back.arrays(), want))
        cam = Camera(target=sim.camera_target).to_dict()
        meta_ok = (back.dt == sim.dt and back.G == sim.G and back.step_count == sim.step_count
                   and back.n_real == sim.n_real and back.loaded_camera.to_dict() == cam
                   and back.state.pos_mass.device == torch.device(dev)
                   and checkpoint.peek_config(str(d)).to_json() == sim.config.replace(dt=sim.dt, G=sim.G).to_json())
        check(same and meta_ok, f"[21a] N={sim.n_real:,} directory round trip to the card: arrays bit-equal, dt "
                                f"{back.dt:g}, G {back.G:g}, step {back.step_count}, camera, peek_config's config")
        check(all(np.array_equal(a, b) for a, b in zip(loaded["npz"].arrays(), want)), "[21a] the .npz round trip")
        check(max(peek) < min(ms["dir load"]) / 10,
              f"[21a] peek_config {peek} ms, under a tenth of a load ({ms['dir load']} ms)")
        del loaded, back
        one = checkpoint._read_dir(str(d), checkpoint._DIR_KEYS)
        with OneRankGroup():
            mesh = SHARDED["x"]
            msim = Simulation(sim.config, *want, step=sim.step_count, mesh=mesh, camera_target=sim.camera_target)
            msim.dt, msim.G = sim.dt, sim.G
            _, save_s = _returns(lambda: msim.save(str(dm)), "the save on a one-rank NCCL mesh")
            mback, load_s = _returns(lambda: Simulation.load(str(dm), mesh=mesh), "the load on the one-rank mesh")
            got = checkpoint._read_dir(str(dm), checkpoint._DIR_KEYS)
            files_same = sorted(got) == sorted(one) and all(torch.equal(got[k], one[k]) for k in one)
            arrays_same = mback is not None and all(
                np.array_equal(a.view(np.uint32), b.view(np.uint32)) for a, b in zip(mback.arrays(), want))
            check(files_same and arrays_same and mback.step_count == sim.step_count,
                  f"[21a] one-rank mesh: the directory's tensors == one device's, the loaded arrays bit-equal "
                  f"(save {save_s:.3f} s, load {load_s:.3f} s)")
            del msim, mback
    print(f"  [21a] N={sim.n_real:,} (step {sim.step_count}), one call each a round, in turns: directory save "
          f"{ms['dir save']} ms, load {ms['dir load']} ms (to the card), {mb_dir:.1f} MB; .npz save "
          f"{ms['npz save']} ms, load {ms['npz load']} ms, {mb_npz:.1f} MB; peek_config {peek} ms", flush=True)


ENERGY_N1 = 32  # 21b: 32^3 = 32,768 bodies, 15a's lattice in 12b's box


def phase_ewald_energy(dev) -> None:
    """21b: ``ewald_potential_energy`` on the card: float32 at 32,768
    bodies (15a's Zel'dovich lattice, box L = 10) against float64 on the
    card, which a 4,096-body subset holds to the host's
    ``ewald_potential_energy_f64``; at N = 256 in float64 autograd's
    gradient against the oracle's ``-m a``."""
    L, n = BOX_L, ENERGY_N1**3
    print(f"[21b Ewald energy] ewald_potential_energy on the card, N={n:,} box {L:g} ({_card()})", flush=True)
    pm_np, _, _ = make_preset("cosmo", seed=11, G=G, n=n, box_size=L, amp=0.02, velocity="eds")
    pm32 = torch.from_numpy(pm_np).to(dev)
    pm64 = pm32.double()
    out: dict = {}
    ms = _in_turns({
        "f32": lambda: out.__setitem__("f32", float(ewald.ewald_potential_energy(pm32, L, chunk=1024))),
        "f64": lambda: out.__setitem__("f64", float(ewald.ewald_potential_energy(pm64, L, chunk=1024))),
    }, rounds=2, reps=1)
    bound = ewald.energy_f32_bound(pm_np, L)
    err = abs(out["f32"] - out["f64"])
    check(err <= bound, f"[21b] N={n:,} float32 {out['f32']!r} vs float64 {out['f64']!r} on the card: |diff| "
                        f"{err:.4e} <= energy_f32_bound {bound:.4e}")
    sub = pm_np[::8]
    t0 = time.perf_counter()
    host = ewald.ewald_potential_energy_f64(sub, L)
    host_s = time.perf_counter() - t0
    card = float(ewald.ewald_potential_energy(torch.from_numpy(sub).to(dev).double(), L))
    rel = abs(card - host) / abs(host)
    check(rel <= 1e-12, f"[21b] {sub.shape[0]:,}-body subset: float64 on the card {card!r} vs the host's "
                        f"ewald_potential_energy_f64 {host!r} ({host_s:.2f} s): rel {rel:.3e} <= 1e-12")
    rng = np.random.default_rng(6)
    box = np.concatenate([rng.uniform(0, 1.0, (256, 3)), rng.uniform(1.0, 3.0, (256, 1))], axis=1)
    pm = torch.from_numpy(box).to(dev)
    sigma = 1.0 / 12.0
    x = pm[:, :3].clone().requires_grad_(True)
    u = ewald.ewald_potential_energy(torch.cat([x, pm[:, 3:]], dim=1), 1.0, eps2=1e-9, sigma=sigma, kmax=14)
    (g,) = torch.autograd.grad(u, x)
    f = pm[:, 3:] * ewald.ewald_accel_reference(pm, 1.0, sigma, eps2=1e-9, n_images=2, kmax=14)
    scale = float(f.abs().max())
    excess = float(((-g - f).abs() / scale - (1e-9 + 1e-7 * f.abs() / scale)).max())
    check(excess <= 0, f"[21b] N=256 float64: -grad U against m a of ewald_accel_reference: max |diff| / scale "
                       f"{float((-g - f).abs().max()) / scale:.3e} (atol 1e-9, rtol 1e-7)")
    print(f"  [21b] N={n:,}, chunk 1,024, one call each a round, in turns: float32 {ms['f32']} ms, float64 "
          f"{ms['f64']} ms; float32 off float64 by {err:.4e} ({err / abs(out['f64']):.3e} of the energy, "
          f"{err / bound:.3f} of the bound)", flush=True)


def run_window(path: str, run, kernels_of_path, dev) -> dict[str, int]:
    """``run(dev)`` with the counts set to 0 just before and read just
    after; it must launch every kernel of ``kernels_of_path`` and no other.
    What ``run`` hands back runs after the counts are read: a profile
    (label, fn[, options]) or a plain callable (a timing in turns)."""
    reset_launch_counts()
    profiles = run(dev) or ()
    got = launch_counts()
    print_clocks(path)
    print(f"  launches in {path}: {json.dumps({k: c for k, c in got.items() if c})}", flush=True)
    for name in KERNELS:
        if name in kernels_of_path:
            check(got[name] > 0, f"{path} launched {name} {got[name]} times")
        elif got[name]:
            check(False, f"{path} launched {name}, which is not of this path, {got[name]} times")
    for item in profiles:
        if callable(item):
            item()
            continue
        label, fn, *opts = item
        profile_window(label, fn, **(opts[0] if opts else {}))
    return got


def _periodic_entry(name: str, t: dict, by_path: dict) -> dict:
    """The kernels line's entry for a kernel's periodic form: its launches
    on the periodic main paths (12b, 12d, 13b, 13c, the comoving 15b and the sharded 18b, 18c;
    also counted in the kernel's ``launches``) and its numbers at 12b's shape (13b's for
    ``short_range_bwd``)."""
    return {
        "replaces": PERIODIC_REPLACES[name],
        "launches": sum(by_path[p][name] for p in PERIODIC_PATHS),
        "launches_by_path": {p: by_path[p][name] for p in PERIODIC_PATHS if by_path[p][name]},
        **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "note")},
        **{k: t[k] for k in ROW_EXTRAS if k in t},
        **({"block_paths": t["block_paths"]} if "block_paths" in t else {}),
        **({"cic_12d": t["cic"]} if "cic" in t else {}),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernels-only", action="store_true", help="stop after the small-shape kernel checks")
    ap.add_argument("--outdir", default=None,
                    help="keep phase 7b's frames and checkpoints here (default: a temporary directory)")
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent commit: time its splat_resolve, mesh_deposit, mesh_gather, "
                         "sym_diag_prep, sym_hops, pair_sym, vjp_sym_hops, vjp_sym_diag, vjp_full, short_range, "
                         "short_range_bwd, force_fast, fused_step_fast, force_exact and fused_step_exact beside "
                         "this tree's, in turns, at 7c's, the deposit's, phase 3's (N = 262,144; the VJP kernels "
                         "also at nt = 157), 14c's (524,288 x 524,288), 8b's, 8d's, 9b's, 12b's, 12d's, 13b's, "
                         "11b's and 11c's shapes (the exact kernels at 40,192 and 262,144), and 6c's gradient "
                         "with either vjp_full; mesh_gather, sym_diag_prep, short_range, short_range_bwd, the "
                         "fast and the exact kernels, vjp_sym_diag's ordered loop and vjp_full at S = 1 also "
                         "bit for bit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: chip_smoke needs a CUDA card", file=sys.stderr)
        return 1
    dev = phase_device()
    phase_build()
    if args.parent:
        load_parent(args.parent)
    phase_kernel_checks(dev)
    phase_vjp_checks(dev)
    phase_vjp_gate(dev)
    phase_render_checks(dev)
    phase_mesh_checks(dev)
    phase_mesh_grad_checks(dev)
    phase_unfused_checks(dev)
    phase_fast_checks(dev)
    phase_periodic_checks(dev)
    phase_periodic_grad_checks(dev)
    phase_macro_checks(dev)
    phase_cosmo_checks(dev)
    phase_device_resolve_checks(dev)
    phase_sharded_replay(dev)
    if args.kernels_only:
        print(f"kernels-only: {len(FAILURES)} failures", flush=True)
        return 1 if FAILURES else 0
    phase_sharded_mesh_replay(dev)
    phase_sharded_render_replay(dev)
    times = phase_kernel_times(dev)

    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(args.outdir or tmp)
        out.mkdir(parents=True, exist_ok=True)
        render_path = (RENDER_PATH[0], functools.partial(phase_render_path, out=out), RENDER_PATH[1])
        by_path = {path: run_window(path, run, ks, dev) for path, run, ks in PATHS + (render_path, SERVE_PATH)}
        t0 = time.perf_counter()
        with OneRankGroup():
            by_path.update({path: run_window(path, run, ks, dev) for path, run, ks in SHARDED_PATHS})
        print(f"  17b-17d, 18b-18d, 19b and 19c with the process group's set-up: {time.perf_counter() - t0:.1f} s",
              flush=True)
        # 16c and 16d: 7b's checkpoint animated, and a traced run; 19d: the dryrun in a spawned rank.
        run_window("phase 16c (cli animate)", functools.partial(phase_animate, out=out), ("splat_resolve",), dev)
        run_window("phase 16d (cli run --trace)", functools.partial(phase_trace, out=out), ("fused_step_exact",), dev)
        run_window("phase 19d (dryrun_multichip(1, 'cuda'), a spawned rank)", phase_dryrun, (), dev)
    run_window("phase 20a (the host disc stamp)", phase_native_raster, (), dev)
    run_window("phase 20b (the float32 JSON codec)", phase_native_json, (), dev)
    run_window("phase 21a (the checkpoint directory)", phase_checkpoint_dir, (), dev)
    run_window("phase 21b (the Ewald energy)", phase_ewald_energy, (), dev)
    times.update(phase_mesh_times(dev))
    times.update(phase_mesh_grad_times(dev))
    times.update(phase_unfused_times(dev))
    phase_exact_times(dev, times)
    times.update(phase_fast_times(dev))
    periodic = phase_periodic_times(dev)
    phase_cosmo_fault(dev)
    periodic.update(phase_periodic_grad_times(dev))
    times.update(phase_macro_times(dev))
    side = {path: run_window(path, run, ks, dev) for path, run, ks in SIDE}
    times.update(phase_render_times(dev))

    kernels = []
    for name in KERNELS:
        if name in LAUNCHES_FROM:
            window = LAUNCHES_FROM[name]
            launches = {"launches": side[window][name], "launches_from": window}
        else:
            launches = {
                "launches": sum(c[name] for c in by_path.values()),
                "launches_by_path": {p: c[name] for p, c in by_path.items() if c[name]},
            }
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": REPLACES[name][0],
            "replaces": REPLACES[name][1],
            **({"also_replaces": list(REPLACES[name][2:])} if len(REPLACES[name]) > 2 else {}),
            **launches,
            "max_abs_err": times[name]["max_abs_err"],
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound_ms"],
            "bound_by": times[name]["bound_by"],
            # Only the resolve, the deposit, the (CIC) gather and the sym
            # combine have one PyTorch call of the same function
            # (scatter_reduce_ "amin" and index_add_ over their pre-expanded
            # pairs, grid_sample, torch.add).
            "library_ms": times[name].get("library_ms"),
            **({"library_note": times[name]["library_note"]} if "library_note" in times[name] else {}),
            **{k: times[name][k] for k in ROW_EXTRAS if k in times[name]},
            **({"scenes": times[name]["scenes"]} if "scenes" in times[name] else {}),
            **({"block_paths": times[name]["block_paths"]} if "block_paths" in times[name] else {}),
            **({"cic_8d": times[name]["cic_8d"]} if "cic_8d" in times[name] else {}),
            **({"periodic": _periodic_entry(name, periodic[name], by_path)} if name in periodic else {}),
        })
    if FAILURES:
        print(f"FAILED {len(FAILURES)} checks: {FAILURES}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
