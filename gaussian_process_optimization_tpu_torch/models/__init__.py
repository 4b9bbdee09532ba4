"""Models (twin of ``gaussian_process_optimization_tpu/models``). Importing the
package attaches the ``m.plot()`` family to the model and kernel classes, as
GPy's ``plotting/__init__.py inject_plotting`` (:41) does."""
from ..utils.plotting_library import inject_plotting as _inject_plotting

_inject_plotting()
