"""Data layer: the ModelNet40 and ShapeNetPart loaders, the h5 datasets,
the augmentations, the threaded batch loader, GeoA3's .mat files and the
synthetic stand-in (the names of `hitadv_tpu.data`)."""

from hitadv_torch.data.synthetic import synthetic_batches, synthetic_clouds  # noqa: F401
from hitadv_torch.data.loader import batch_iterator, device_put_batches  # noqa: F401
from hitadv_torch.data.modelnet import (  # noqa: F401
    MODELNET40_CLASSES,
    ModelNet40H5,
    ModelNetDataset,
    fps_numpy,
    load_h5_cls,
    pc_normalize,
)
from hitadv_torch.data.shapenet import PartNormalDataset  # noqa: F401
from hitadv_torch.data.geoa3_mat import (  # noqa: F401
    TEN_LABEL_INDEXES,
    TEN_LABEL_NAMES,
    GeoA3ModelNet40,
)
from hitadv_torch.data import provider  # noqa: F401
from hitadv_torch.data.extra_h5 import (  # noqa: F401,E402
    S3DISH5,
    ScanNetBlocks,
    ShapeNetPartH5,
    load_data_partseg,
    load_data_semseg,
)
