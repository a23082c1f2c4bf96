from setuptools import find_packages, setup

setup(
    name='sailfish_tpu',
    version='0.1.0',
    description='TPU-native lattice-Boltzmann CFD framework '
                '(JAX/XLA/Pallas rebuild of the Sailfish scene API), '
                'with its PyTorch/CUDA port sailfish_tpu_torch',
    packages=find_packages(include=['sailfish_tpu', 'sailfish_tpu.*',
                                    'sailfish_tpu_torch',
                                    'sailfish_tpu_torch.*']),
    package_data={'sailfish_tpu_torch': ['ops/csrc/*.cu', 'ops/csrc/*.cuh']},
    python_requires='>=3.10',
)
