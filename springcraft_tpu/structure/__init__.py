"""
Host-side structure layer: AtomArray container, PDB I/O, chemical info
and neighbor search.  Replacement for the parts of *biotite*
the reference framework depends on.
"""

from . import info
from .atoms import (
    AtomArray,
    BadStructureError,
    array,
    as_atom_array,
    check_res_id_continuity,
    concatenate,
    coord,
    displacement,
    distance,
    filter_amino_acids,
    get_chain_count,
    index_displacement,
    is_atom_array_like,
)
from .bcif import load_structure_bcif, read_bcif_as_cif
from .celllist import CellList
from .cif import CIFFile, load_structure_cif
from .pdb import (
    PDBFile,
    get_structure,
    load_ensemble,
    load_structure,
    write_pdb,
)

__all__ = [
    "AtomArray",
    "BadStructureError",
    "array",
    "as_atom_array",
    "is_atom_array_like",
    "concatenate",
    "coord",
    "displacement",
    "index_displacement",
    "distance",
    "get_chain_count",
    "check_res_id_continuity",
    "filter_amino_acids",
    "CellList",
    "PDBFile",
    "CIFFile",
    "get_structure",
    "load_structure",
    "load_structure_cif",
    "load_structure_bcif",
    "read_bcif_as_cif",
    "load_ensemble",
    "write_pdb",
    "info",
]
