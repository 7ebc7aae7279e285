from repro_torch.dicom.tags import TAGS, TagInfo, keyword_for
from repro_torch.dicom.dataset import DicomDataset, new_uid
from repro_torch.dicom.generator import StudyGenerator, SyntheticStudy
from repro_torch.dicom import codec

__all__ = [
    "TAGS",
    "TagInfo",
    "keyword_for",
    "DicomDataset",
    "new_uid",
    "StudyGenerator",
    "SyntheticStudy",
    "codec",
]
