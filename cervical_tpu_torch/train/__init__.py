"""Model construction, the segmentation trainer, LR schedules and weight
import."""
