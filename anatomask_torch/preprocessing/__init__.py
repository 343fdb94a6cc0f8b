"""Raw-case preprocessing: cropping, normalization, resampling and the
DefaultPreprocessor (counterpart of anatomask_tpu/preprocessing/)."""
