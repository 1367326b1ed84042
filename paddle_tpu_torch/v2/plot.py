"""Training-curve plotting (reference: python/paddle/v2/plot/plot.py
Ploter — matplotlib in notebooks, text fallback otherwise).  A copy of
paddle_tpu/v2/plot.py."""

__all__ = ["Ploter"]


class PlotData:
    def __init__(self):
        self.step = []
        self.value = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(value)

    def reset(self):
        self.step = []
        self.value = []


class Ploter:
    """Collects (step, value) series per title and plots/prints them
    (reference: v2/plot/plot.py — same append/plot/reset surface)."""

    def __init__(self, *titles):
        self.__args__ = titles
        self.__plot_data__ = {t: PlotData() for t in titles}
        self.__disable_plot__ = self._matplotlib_missing()

    @staticmethod
    def _matplotlib_missing():
        try:
            import matplotlib  # noqa: F401

            return False
        except ImportError:
            return True

    def append(self, title, step, value):
        assert title in self.__plot_data__, (
            "title %s not found in %s" % (title, list(self.__plot_data__)))
        self.__plot_data__[title].append(step, float(value))

    def plot(self, path=None):
        if self.__disable_plot__:
            for title, data in self.__plot_data__.items():
                if data.step:
                    print("%s: step=%d value=%f"
                          % (title, data.step[-1], data.value[-1]))
            return
        import matplotlib.pyplot as plt

        for title, data in self.__plot_data__.items():
            plt.plot(data.step, data.value, label=title)
        plt.legend()
        if path:
            plt.savefig(path)
        else:
            plt.draw()
        plt.clf()

    def reset(self):
        for data in self.__plot_data__.values():
            data.reset()
