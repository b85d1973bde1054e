"""Shared Criteo-style field vocabulary (39 sparse fields), the port's
own copy of `repro.configs.recsys_common`.

26 categorical cardinalities follow the published Criteo-Kaggle statistics;
the 13 'dense' features are bucketized to 1000 bins each (standard DLRM
preprocessing), giving 33,775,577 embedding rows in all (33,775,616 once
padded to a multiple of 2048).
"""

CRITEO_CAT = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)
DENSE_BUCKETS = (1000,) * 13
CRITEO_39 = DENSE_BUCKETS + CRITEO_CAT

SMOKE_FIELDS_6 = (50, 50, 200, 200, 30, 30)
