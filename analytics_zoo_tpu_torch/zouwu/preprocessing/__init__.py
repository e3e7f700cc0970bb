from .impute import (BaseImputation, FillZeroImpute, LastFill,
                     LastFillImpute, LinearImpute, MeanImpute,
                     TimeMergeImputor)
