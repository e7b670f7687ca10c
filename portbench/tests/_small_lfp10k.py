"""Tiny sizes of ``lfp10k`` for the CPU tests: the same structure, engine
settings and limits in 2x5x6 cells (the smallest olivine supercell found
to take the gather route): 240 Li sites, all centred, 1440 static atoms,
144 ions (Li0.6), passes of 64 frames over a pool of 32 in blocks of
16."""
SMALL = dict(n_cells=[2, 5, 6], n_static=1440, n_sites=240, n_ions=144,
             n_centres=240, centred_block=[[0, 8, 1], [0, 10, 1],
                                           [0, 12, 1]],
             n_frames=64, distinct_frames=32, block_frames=16)
