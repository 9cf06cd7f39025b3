"""Residue and atom vocabularies (the port's own copy of
`jamun_tpu/data/residue_metadata.py`): 5 atom types, 6 atom codes, 22 residue
codes (20 amino acids and the ACE/NME caps); an unknown name encodes as the
length of its list.
"""

from __future__ import annotations

from typing import Dict, List

__all__ = [
    "ResidueMetadata",
    "encode_atom_type",
    "encode_atom_code",
    "encode_residue",
    "convert_to_three_letter_codes",
    "convert_to_one_letter_codes",
]


class ResidueMetadata:
    ATOM_TYPES: List[str] = ["C", "O", "N", "F", "S"]
    ATOM_CODES: List[str] = ["C", "O", "N", "S", "CA", "CB"]
    RESIDUE_CODES: List[str] = [
        "ALA", "ARG", "ASN", "ASP", "CYS", "GLU", "GLN", "GLY", "HIS", "ILE",
        "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
        "ACE", "NME",
    ]
    AA_3CODES: Dict[str, str] = {
        "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
        "E": "GLU", "Q": "GLN", "G": "GLY", "H": "HIS", "I": "ILE",
        "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
        "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL",
    }
    AA_1CODES: Dict[str, str] = {v: k for k, v in AA_3CODES.items()}


def encode_atom_type(atom_type: str) -> int:
    try:
        return ResidueMetadata.ATOM_TYPES.index(atom_type)
    except ValueError:
        return len(ResidueMetadata.ATOM_TYPES)


def encode_atom_code(atom_code: str) -> int:
    try:
        return ResidueMetadata.ATOM_CODES.index(atom_code)
    except ValueError:
        return len(ResidueMetadata.ATOM_CODES)


def encode_residue(residue_name: str) -> int:
    try:
        return ResidueMetadata.RESIDUE_CODES.index(residue_name)
    except ValueError:
        return len(ResidueMetadata.RESIDUE_CODES)


def convert_to_three_letter_code(aa: str) -> str:
    aa = aa.upper()
    if len(aa) == 1:
        if aa not in ResidueMetadata.AA_3CODES:
            raise ValueError(f"Invalid one-letter amino acid code: {aa}")
        return ResidueMetadata.AA_3CODES[aa]
    if len(aa) == 3:
        if aa not in ResidueMetadata.AA_1CODES:
            raise ValueError(f"Invalid three-letter amino acid code: {aa}")
        return aa
    raise ValueError(f"Invalid amino acid code length: {aa}")


def convert_to_three_letter_codes(peptide: str) -> str:
    if "_" in peptide:
        return peptide
    return "_".join(convert_to_three_letter_code(aa) for aa in peptide)


def convert_to_one_letter_code(aa: str) -> str:
    aa = aa.upper()
    if len(aa) == 1:
        if aa not in ResidueMetadata.AA_3CODES:
            raise ValueError(f"Invalid one-letter amino acid code: {aa}")
        return aa
    if len(aa) == 3:
        if aa not in ResidueMetadata.AA_1CODES:
            raise ValueError(f"Invalid three-letter amino acid code: {aa}")
        return ResidueMetadata.AA_1CODES[aa]
    raise ValueError(f"Invalid amino acid code length: {aa}")


def convert_to_one_letter_codes(peptide: str) -> str:
    if "_" not in peptide:
        return peptide
    return "".join(convert_to_one_letter_code(aa) for aa in peptide.split("_"))
