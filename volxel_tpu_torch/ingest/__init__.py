from volxel_tpu_torch.ingest.dicom import DicomFile, parse_dicom  # noqa: F401
from volxel_tpu_torch.ingest.series import (  # noqa: F401
    DicomSeries,
    read_dicom_series,
    read_dicoms_to_grid,
)
from volxel_tpu_torch.ingest.ziploader import read_zip_to_grid, read_zip_series  # noqa: F401
from volxel_tpu_torch.ingest.hdr import decode_hdr, decode_env_bytes  # noqa: F401
