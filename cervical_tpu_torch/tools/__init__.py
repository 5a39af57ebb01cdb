"""Dataset ETL tools — the port's copies of ``cervical_tpu/tools``:
labelbox/labelme conversion, mask recoloring, split generation and audit,
offline 8x segmentation and 5x multimodal augmentation."""
