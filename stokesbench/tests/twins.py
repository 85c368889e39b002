"""Small twins of the benchmark's cells, which a CPU test run can hold: the
bacterium on a 26-node head and the 16 x 6 tube, four frames a turn (its
auto-promotion fires, so the near delta runs), the sphere on
create_sphere(2) beside the wall, the matrix-free blocks of 64 nodes."""

TWINS = {
    "bacterium-loop": (dict(head_refinements=1, tube=[16, 6], frames_per_turn=4), dict(n_frames=4)),
    "bacterium-matfree": (
        dict(head_refinements=1, tube=[16, 6], frames_per_turn=4),
        dict(n_frames=4, matfree_block_nodes=64),
    ),
    "sphere_wall-loop": (dict(refinements=2), {}),
}

#: a seed past 32 signed bits, as the benchmark's driver gives
SEED = 2**31 + 12345
