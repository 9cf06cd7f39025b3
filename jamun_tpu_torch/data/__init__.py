"""Data: topology and PDB/DCD files, datasets, discovery, bucketed batching
and the DataModule (counterpart of `jamun_tpu/data/`, numpy only up to the
`GraphBatch` that `collate` makes)."""

from jamun_tpu_torch.data.batching import BucketSpec, collate, pad_to_bucket, template_to_batch
from jamun_tpu_torch.data.datamodule import DataModule
from jamun_tpu_torch.data.datasets import (
    IterableTrajectoryDataset,
    StreamingRandomChainDataset,
    TrajectoryDataset,
)
from jamun_tpu_torch.data.dcd import read_dcd, write_dcd
from jamun_tpu_torch.data.discovery import create_dataset_from_pdbs, parse_datasets_from_directory
from jamun_tpu_torch.data.residue_metadata import (
    ResidueMetadata,
    encode_atom_code,
    encode_atom_type,
    encode_residue,
)
from jamun_tpu_torch.data.topology import (
    GraphTemplate,
    Topology,
    load_pdb,
    preprocess_topology,
    save_pdb,
)
