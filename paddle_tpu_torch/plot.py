"""Training curves (a copy of ``paddle_tpu/plot.py``; reference:
v2/plot/plot.py Ploter): (step, value) series drawn with matplotlib when
it is installed, else one summary line a series on standard output, so a
headless loop can call it unconditionally."""

from __future__ import annotations

from typing import Dict, List, Tuple


class Ploter:
    def __init__(self, *titles: str):
        self.titles = list(titles)
        self.data: Dict[str, Tuple[List[float], List[float]]] = {
            t: ([], []) for t in titles}

    def append(self, title: str, step: float, value: float) -> None:
        xs, ys = self.data[title]
        xs.append(float(step))
        ys.append(float(value))

    def reset(self) -> None:
        for xs, ys in self.data.values():
            xs.clear()
            ys.clear()

    def plot(self, path: str = None) -> None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            for t, (xs, ys) in self.data.items():
                tail = ys[-1] if ys else float("nan")
                print(f"[plot] {t}: {len(xs)} points, last={tail:.5f}")
            return
        plt.figure()
        for t, (xs, ys) in self.data.items():
            plt.plot(xs, ys, label=t)
        plt.legend()
        plt.xlabel("step")
        if path:
            plt.savefig(path)
        plt.close()
