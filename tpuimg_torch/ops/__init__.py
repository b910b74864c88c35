from tpuimg_torch.ops.gaussian import gaussian
from tpuimg_torch.ops.guided import box_filter, guided_filter
from tpuimg_torch.ops.histogram import clahe, hist_equalize
from tpuimg_torch.ops.integral import integral
from tpuimg_torch.ops.morphology import dilate, erode, morph_close, morph_open

__all__ = ["box_filter", "clahe", "dilate", "erode", "gaussian",
           "guided_filter", "hist_equalize", "integral", "morph_close",
           "morph_open"]
