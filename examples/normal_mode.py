"""
Normal-mode animation
=====================

Creates a multi-model PDB trajectory depicting the first non-trivial
ANM mode (the device counterpart of the reference gallery script
``doc/examples/scripts/normal_mode.py``): load it in PyMOL / ChimeraX /
VMD to watch the motion.

Run:  python examples/normal_mode.py [path/to/structure.pdb]
"""

import sys
from os.path import abspath, dirname, join

sys.path.insert(0, dirname(dirname(abspath(__file__))))  # in-repo run

import springcraft_tpu as sc
from springcraft_tpu.structure import load_structure, write_pdb

MODE = 6          # first non-trivial mode (0-5 are rigid-body motions)
AMPLITUDE = 3.0   # peak displacement of the most mobile atom, in A
FRAMES = 20       # frames per oscillation

path = sys.argv[1] if len(sys.argv) > 1 else join(
    dirname(dirname(__file__)), "tests", "data", "1l2y.pdb"
)

atoms = load_structure(path, model=1)
ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]

ff = sc.HinsenForceField()
anm = sc.ANM(ca, ff)

# Displacements for one full oscillation of the chosen mode
displacements = anm.normal_mode(MODE, amplitude=AMPLITUDE, frames=FRAMES)
trajectory = ca.coord[None] + displacements

write_pdb("normal_mode.pdb", ca, coord_models=trajectory)
print(f"wrote normal_mode.pdb ({FRAMES} models, mode {MODE})")
