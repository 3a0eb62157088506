"""``selfies`` / ``rdkit``-shaped adapters over the vendored toolkit.

``data/prepare.py`` was written against the optional real dependencies
(``reference/requirements.txt:129``); its module-level seams
(``_selfies``, ``_Chem``, ``_Desc``) accept anything with the same
call signatures. These adapters plug the vendored chemistry into those
seams so the REAL pipeline (tokenization, property computation,
chemical validity) executes when the libraries are absent — which is
every environment this repo has ever run in.
"""

from __future__ import annotations

from mlx_vae_tpu_torch.chem import descriptors as _ds
from mlx_vae_tpu_torch.chem import selfies_codec as _sc
from mlx_vae_tpu_torch.chem import smiles as _sm

BACKEND = "vendored"


class EncoderError(ValueError):
    pass


class selfies:  # noqa: N801 - mimics the module it stands in for
    EncoderError = EncoderError

    @staticmethod
    def encoder(smi: str) -> str:
        out = _sc.smiles_to_selfies(smi)
        if out is None:
            raise EncoderError(f"SMILES does not parse: {smi!r}")
        return out

    @staticmethod
    def split_selfies(s: str):
        return _sc.split_selfies(s)

    @staticmethod
    def decoder(s: str) -> str:
        if not s:
            return ""
        out = _sc.selfies_to_smiles(s)
        return out if out is not None else ""


class Chem:  # noqa: N801
    @staticmethod
    def MolFromSmiles(smi: str):  # noqa: N802
        if not isinstance(smi, str) or not smi:
            return None
        return _sm.mol_from_smiles(smi)

    @staticmethod
    def MolToSmiles(mol) -> str:  # noqa: N802
        return _sm.mol_to_smiles(mol)


class Descriptors:  # noqa: N801
    @staticmethod
    def TPSA(mol) -> float:  # noqa: N802
        return _ds.tpsa(mol)

    @staticmethod
    def MolLogP(mol) -> float:  # noqa: N802
        return _ds.clogp(mol)

    @staticmethod
    def MolWt(mol) -> float:  # noqa: N802
        return _ds.mol_weight(mol)
