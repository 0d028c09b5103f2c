"""The kernels of the port and their plain versions.  Importing the
package registers the served kernels as ``dvie::`` ops
(``ops/library.py``)."""

from deep_video_interpolation_extrapolation_tpu_torch.ops import (  # noqa: F401
    library,
)
